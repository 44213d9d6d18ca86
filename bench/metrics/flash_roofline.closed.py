"""flash_roofline.closed: the flash-prefill kernel's share of its roofline
over the traced window's calls (readers.roofline_share)."""

from readers import roofline_share


def read(run):
    return roofline_share(run, "flash")
