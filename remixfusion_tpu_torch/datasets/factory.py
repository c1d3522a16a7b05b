"""Dataset factory: config['dataset'] string -> loader instance.

Counterpart of remixfusion_tpu.datasets.factory (reference
datasets/dataset.py:12-53): the analytic synthetic scenes (the orbit room
and the multi-room building) and the eleven real-sensor loaders of
datasets/loaders.py.
"""

from __future__ import annotations


def get_dataset(config):
    # normalize the reference's mixed-case names ('Fast_syn', 'BS3D',
    # 'Largeindoor', reference datasets/dataset.py:12-47)
    name = config["dataset"].lower().replace("_", "")
    if name == "synthetic":
        from remixfusion_tpu_torch.datasets.synthetic import SyntheticDataset
        return SyntheticDataset(config)
    if name == "syntheticlarge":
        from remixfusion_tpu_torch.datasets.synthetic import \
            SyntheticLargeDataset
        return SyntheticLargeDataset(config)

    from remixfusion_tpu_torch.datasets import loaders

    table = {
        "replica": loaders.ReplicaDataset,
        "bs3d": loaders.BS3DDataset,
        "scannet": loaders.ScannetDataset,
        "tum": loaders.TUMDataset,
        "fastsyn": loaders.FastsynDataset,
        "uhumans": loaders.UhumansDataset,
        "azure": loaders.AzureDataset,
        "iphone": loaders.IPhoneDataset,
        "rgb": loaders.RGBDataset,
        "realsense": loaders.RealsenseDataset,
        "largeindoor": loaders.LargeindoorDataset,
    }
    if name not in table:
        raise ValueError(f"unknown dataset type {config['dataset']}")
    return table[name](config)
