"""What the port does not do yet, and the ROADMAP.md item that brings it."""

ROADMAP_ITEMS = {
    "chi2": "queue 1 item 1, flat-index remainder",
    "int8": "queue 2 item 4, int8 kernels",
    "serving": "queue 1 item 3, on-host serving latency",
    "bovw": "queue 1 item 5, descriptors, BoVW and dHash",
    "backbone": "queue 1 item 6, other backbones and training",
    "multi-device": "queue 1 item 7, multi-device",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error to raise for ``what``, naming its ROADMAP.md item."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {ROADMAP_ITEMS[item]})")
