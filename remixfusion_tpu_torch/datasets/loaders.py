"""Real-sensor RGB-D dataset loaders.

Counterpart of remixfusion_tpu.datasets.loaders (reference
datasets/dataset.py:89-1506): Replica, FastCaMo-synth, BS3D, uHumans2,
ScanNet, Azure, generic RGB-D, Realsense, Largeindoor, iPhone and TUM. All
share one __getitem__ pipeline (BGR->RGB, /255, depth / png_depth_scale *
sc_factor, colour resized to the depth size, optional downsample /
crop_size resize / crop_edge trim) and differ only in file discovery and
pose parsing. Images go through utils/imageio (the port's own PNG decoder;
JPEG through OpenCV), which gives the frames cv2 gives: depth, poses and
PNG colour bitwise, resized colour within 1e-13. Frames are numpy arrays
on the host, as the synthetic dataset's are.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from remixfusion_tpu_torch.core.rays import as_intrinsics_matrix
from remixfusion_tpu_torch.datasets.base import BaseDataset
from remixfusion_tpu_torch.utils import imageio


def _pose_from_tq(pvec):
    """(tx ty tz qx qy qz qw) -> 4x4 c2w."""
    from scipy.spatial.transform import Rotation

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
    pose[:3, 3] = pvec[:3]
    return pose


def _alphanum_key(s):
    import re
    return [int(x) if x.isdigit() else x
            for x in re.split(r"([0-9]+)", s)]


def _flat_4x4_rows(path, n, sc_factor):
    """The first n flat 4x4 rows of a trajectory file, translation scaled."""
    with open(path) as f:
        lines = f.readlines()
    poses = []
    for i in range(n):
        c2w = np.array(list(map(float, lines[i].split())),
                       np.float32).reshape(4, 4)
        c2w[:3, 3] *= sc_factor
        poses.append(c2w)
    return poses


def _pose_files(basedir, key=None):
    """Per-frame 4x4 pose files pose/*.txt, sorted by `key` or by name."""
    paths = sorted(glob.glob(os.path.join(basedir, "pose", "*.txt")),
                   key=key)
    return [np.loadtxt(p).reshape(4, 4).astype(np.float32) for p in paths]


def _numeric_stem(path):
    return int(os.path.basename(path)[:-4])


def _alphanum_name(path):
    return _alphanum_key(os.path.basename(path))


class FileRGBDDataset(BaseDataset):
    """Shared frame-loading pipeline over (img_files, depth_paths, poses)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.basedir = cfg["data"]["datadir"]
        self.trainskip = cfg["data"].get("trainskip", 1)
        self.downsample_factor = cfg["data"]["downsample"]
        self.sc_factor = cfg["data"]["sc_factor"]
        self.translation = cfg["data"]["translation"]
        self.img_files: list[str] = []
        self.depth_paths: list[str] = []
        self.poses: list[np.ndarray] = []
        self._undistorter = None

    def _finalize(self):
        max_frames = self.config["data"].get("max_frames")
        if max_frames:
            self.img_files = self.img_files[:max_frames]
            self.depth_paths = self.depth_paths[:max_frames]
            self.poses = self.poses[:max_frames]
        self.frame_ids = list(range(len(self.img_files)))

    def __len__(self):
        return len(self.img_files)

    def _undistort(self, color):
        """cv2.undistort with the config's current intrinsics (the
        pipeline has already rescaled them for crop_size / crop_edge, as
        in the JAX loader); the map is built once per image size."""
        cam = self.config["cam"]
        K = as_intrinsics_matrix([cam["fx"], cam["fy"], cam["cx"],
                                  cam["cy"]])
        u = self._undistorter
        key = (K.tobytes(), color.shape[:2])
        if u is None or u[0] != key:
            u = (key, imageio.Undistorter(K, self.distortion,
                                          *color.shape[:2]))
            self._undistorter = u
        return u[1](color)

    def __getitem__(self, index):
        color_path = self.img_files[index]
        depth_path = self.depth_paths[index]
        if depth_path.endswith(".exr"):
            raise NotImplementedError("EXR depth not supported")
        color_data = imageio.imread_color(color_path)
        depth_data = imageio.imread_unchanged(depth_path)

        if self.distortion is not None:
            color_data = self._undistort(color_data)

        color_data = color_data / 255.0
        depth_data = (depth_data.astype(np.float32)
                      / self.png_depth_scale * self.sc_factor)

        H, W = depth_data.shape
        color_data = imageio.resize(color_data, H, W)

        if self.downsample_factor > 1:
            H = H // self.downsample_factor
            W = W // self.downsample_factor
            color_data = imageio.resize(color_data, H, W, "area")
            depth_data = imageio.resize(depth_data, H, W, "nearest")

        if self.crop_size is not None:
            # resize to crop_size (+ edge) like the reference's lietorch
            # preprocessing (dataset.py:609-614, 1182-1189)
            edge2 = self.config["cam"]["crop_edge"] * 2
            out_h = self.crop_size[0] + edge2
            out_w = self.crop_size[1] + edge2
            color_data = imageio.resize(color_data, out_h, out_w)
            depth_data = imageio.resize(depth_data, out_h, out_w, "nearest")

        edge = self.config["cam"]["crop_edge"]
        if edge > 0:
            color_data = color_data[edge:-edge, edge:-edge]
            depth_data = depth_data[edge:-edge, edge:-edge]

        return {
            "frame_id": self.frame_ids[index],
            "c2w": self.poses[index],
            "rgb": color_data.astype(np.float32),
            "depth": depth_data.astype(np.float32),
            "direction": np.asarray(self.get_direction()),
        }


class ReplicaDataset(FileRGBDDataset):
    """frame*.jpg / depth*.png + traj.txt of flat 4x4 rows
    (reference dataset.py:203-298)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.img_files = sorted(
            glob.glob(f"{self.basedir}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.basedir}/results/depth*.png"))
        self.poses = _flat_4x4_rows(os.path.join(self.basedir, "traj.txt"),
                                    len(self.img_files), self.sc_factor)
        self._finalize()


class FastsynDataset(ReplicaDataset):
    """FastCaMo-synth: color/*.png + depth/*.png, else the Replica layout;
    traj.txt of flat 4x4 rows (reference dataset.py:301-397)."""

    def __init__(self, cfg):
        FileRGBDDataset.__init__(self, cfg)
        self.img_files = sorted(
            glob.glob(os.path.join(self.basedir, "color", "*.png")),
            key=_alphanum_name)
        if not self.img_files:
            self.img_files = sorted(
                glob.glob(f"{self.basedir}/results/frame*.jpg"))
            self.depth_paths = sorted(
                glob.glob(f"{self.basedir}/results/depth*.png"))
        else:
            self.depth_paths = sorted(
                glob.glob(os.path.join(self.basedir, "depth", "*.png")),
                key=_alphanum_name)
        self.poses = _flat_4x4_rows(os.path.join(self.basedir, "traj.txt"),
                                    len(self.img_files), self.sc_factor)
        self._finalize()


class BS3DDataset(FileRGBDDataset):
    """color/*.jpg|png + depth/*.png + poses.txt (idx tx ty tz qx qy qz qw)
    (reference dataset.py:538-672)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        for ext in ("jpg", "png"):
            files = sorted(
                glob.glob(os.path.join(self.basedir, "color", f"*.{ext}")),
                key=_alphanum_name)
            if files:
                self.img_files = files
                break
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.basedir, "depth", "*.png")),
            key=_alphanum_name)
        poses = np.loadtxt(os.path.join(self.basedir, "poses.txt"),
                           dtype=np.float64)
        for row in poses:
            self.poses.append(_pose_from_tq(row[1:]))
        self._finalize()


class UhumansDataset(BS3DDataset):
    """uHumans2 uses the BS3D organized layout after preprocessing
    (reference dataset.py:1207-1396, preprocess/preprocess.py)."""


class ScannetDataset(FileRGBDDataset):
    """color/*.jpg + depth/*.png + pose/*.txt per frame
    (reference dataset.py:675-779)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.img_files = sorted(
            glob.glob(os.path.join(self.basedir, "color", "*.jpg")),
            key=_numeric_stem)
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.basedir, "depth", "*.png")),
            key=_numeric_stem)
        self.poses = _pose_files(self.basedir, key=_numeric_stem)
        self._finalize()


class AzureDataset(ScannetDataset):
    """Azure Kinect captures in the ScanNet-style layout, names sorted as
    strings (reference dataset.py:782-896)."""

    def __init__(self, cfg):
        FileRGBDDataset.__init__(self, cfg)
        self.img_files = sorted(
            glob.glob(os.path.join(self.basedir, "color", "*.jpg")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.basedir, "depth", "*.png")))
        self.poses = _pose_files(self.basedir)
        self._finalize()


class RGBDataset(AzureDataset):
    """Generic organized RGB-D capture (reference dataset.py:898-1006)."""


class RealsenseDataset(AzureDataset):
    """Realsense captures in the organized layout
    (reference dataset.py:1398-1506)."""


class LargeindoorDataset(ScannetDataset):
    """Large indoor captures; ScanNet-style layout with png color
    (reference dataset.py:399-536)."""

    def __init__(self, cfg):
        FileRGBDDataset.__init__(self, cfg)
        self.img_files = sorted(
            glob.glob(os.path.join(self.basedir, "color", "*.png")),
            key=_alphanum_name)
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.basedir, "depth", "*.png")),
            key=_alphanum_name)
        self.poses = _pose_files(self.basedir, key=_numeric_stem)
        self._finalize()


class IPhoneDataset(FileRGBDDataset):
    """iPhone captures: images/ + depth/ + odometry.csv
    (reference dataset.py:89-201)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.img_files = [
            os.path.join(self.basedir, "images", f)
            for f in sorted(os.listdir(os.path.join(self.basedir, "images")),
                            key=_alphanum_key) if f.endswith("png")]
        self.depth_paths = [
            os.path.join(self.basedir, "depth", f)
            for f in sorted(os.listdir(os.path.join(self.basedir, "depth")),
                            key=_alphanum_key) if f.endswith("png")]
        pose_data = np.loadtxt(os.path.join(self.basedir, "odometry.csv"),
                               delimiter=",", skiprows=1)
        # columns: ... x y z qx qy qz qw (reference dataset.py:176-199)
        for row in pose_data[: len(self.img_files)]:
            self.poses.append(_pose_from_tq(row[2:9]))
        self._finalize()


class TUMDataset(FileRGBDDataset):
    """TUM RGB-D: rgb.txt/depth.txt/groundtruth.txt timestamp association
    with frame-rate subsampling (reference dataset.py:1009-1204)."""

    def __init__(self, cfg, frame_rate: int = 32):
        super().__init__(cfg)
        self.img_files, self.depth_paths, self.poses = self._load_tum(
            self.basedir, frame_rate)
        self._finalize()

    @staticmethod
    def _parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=str,
                          skiprows=skiprows)

    @staticmethod
    def _associate(tstamp_image, tstamp_depth, tstamp_pose, max_dt=0.08):
        associations = []
        for i, t in enumerate(tstamp_image):
            j = np.argmin(np.abs(tstamp_depth - t))
            k = np.argmin(np.abs(tstamp_pose - t))
            if (abs(tstamp_depth[j] - t) < max_dt
                    and abs(tstamp_pose[k] - t) < max_dt):
                associations.append((i, j, k))
        return associations

    def _load_tum(self, datapath, frame_rate):
        if os.path.isfile(os.path.join(datapath, "groundtruth.txt")):
            pose_list = os.path.join(datapath, "groundtruth.txt")
        else:
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_dep = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_dep, t_pose)

        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, image_data[i, 1]))
            depths.append(os.path.join(datapath, depth_data[j, 1]))
            poses.append(_pose_from_tq(pose_vecs[k]))
        return images, depths, poses
