"""paged_roofline.closed: the paged-decode kernel's share of its roofline
over the traced window's calls (readers.roofline_share)."""

from readers import roofline_share


def read(run):
    return roofline_share(run, "paged")
