"""``ei_diff``'s share (%) of its roofline in the traced part of a
batch cell's window (its TPE generations): ``roofline.ei_diff_share``."""


def read(art):
    if not art.get("events"):
        return None
    return art["roofline"].ei_diff_share(art["events"], art["cfg"]["ei_diff_shapes"],
                                         art.get("tpe_steps", 0))
