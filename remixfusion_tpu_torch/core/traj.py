"""Trajectory recorder: TUM-format export + re-center anchor state.

Counterpart of remixfusion_tpu.core.traj (reference model/traj.py:23-108):
accumulates (timestamp, c2w) pairs, converts rotations to quaternions for
TUM-format '.txt' export (scipy's Rotation, as the JAX package), and
carries the kfx/kfy/kfz/first anchors of the reference's re-center policy
(tracking/volume.MovingVolume keeps its own; this class is the standalone
recorder and export API).
"""

from __future__ import annotations

import numpy as np

from scipy.spatial.transform import Rotation


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (qx, qy, qz, qw)."""
    return Rotation.from_matrix(np.asarray(R, np.float64)).as_quat()


class Trajectory:
    def __init__(self, save_path: str = "./results/"):
        self.save_path = save_path
        self.timestamps: list[float] = []
        self.poses: list[np.ndarray] = []
        # moving-volume re-center anchors (reference traj.py state)
        self.kfx = 0.0
        self.kfy = 0.0
        self.kfz = 0.0
        self.first = -1

    def add(self, timestamp: float, c2w: np.ndarray):
        self.timestamps.append(float(timestamp))
        self.poses.append(np.asarray(c2w, np.float64))

    def __len__(self):
        return len(self.poses)

    def as_array(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 4, 4))

    def write_tum(self, path: str):
        """'timestamp tx ty tz qx qy qz qw' per line."""
        with open(path, "w") as f:
            for t, c2w in zip(self.timestamps, self.poses):
                q = rotation_to_quaternion(c2w[:3, :3])
                tx, ty, tz = c2w[:3, 3]
                f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")

    @staticmethod
    def read_tum(path: str) -> "Trajectory":
        traj = Trajectory()
        data = np.loadtxt(path)
        for row in np.atleast_2d(data):
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(row[4:8]).as_matrix()
            c2w[:3, 3] = row[1:4]
            traj.add(row[0], c2w)
        return traj
