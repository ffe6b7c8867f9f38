"""Fr elements through every transform of the window (length times batch of
each inverse, coset and coset-inverse call) over the window's seconds (host
clock)."""


def read(rec):
    if not rec["transform_elems"]:
        return None
    return rec["transform_elems"] / rec["window_s"]
