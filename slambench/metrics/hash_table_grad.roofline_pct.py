"""Share (%) of its roofline that hash_table_grad reached in the traced
sub-window: the least time its launches could take (operations or bytes
at the card's peak, counted from each launch's inputs by
harness/roofline.py) over the device time of its kernels. Nothing when it
did not run."""


def read(s):
    k = s.get("hash_table_grad")
    if not k or not k["launches"] or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
