"""RO-only ATE (cm) of frames 0..199: the tracker's raw poses, Horn-aligned
onto the ground truth (harness/ate.py)."""


def read(s):
    return s.get("ate_ro_cm")
