"""CLI entry point of the port's rendering evaluation (the counterpart of
rendering_eval.py, as run_torch.py is of run.py):

    python rendering_eval_torch.py --config <yaml> [--ckpt checkpoint.npz] \
        [--gap 10] [--save] [--device cuda|cpu]

Run a config with mapping.save_ckpt first (`python run_torch.py --config
configs/Synthetic/rendering_eval_example.yaml`), then score its renders:
`python rendering_eval_torch.py --config
configs/Synthetic/rendering_eval_example.yaml --gap 5` prints each frame's
PSNR, SSIM and depth-L1, their means with the perceptual distance (LPIPS
when remixfusion_tpu_torch/assets/lpips_alex.npz is present, else the
random-feature proxy), and a JSON line of the same numbers with each
frame's render time. See remixfusion_tpu_torch/tools/rendering_eval.py.
"""

from remixfusion_tpu_torch.tools.rendering_eval import main

if __name__ == "__main__":
    main()
