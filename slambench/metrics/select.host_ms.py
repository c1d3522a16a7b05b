"""Host ms a frame in brick selection and re-centring: the program's
slice.select and slice.lookahead spans over the traced frames."""


def read(s):
    spans = s["span_s"]
    if "slice.select" not in spans:
        return None
    total = spans["slice.select"] + spans.get("slice.lookahead", 0.0)
    return 1e3 * total / s["frames"]
