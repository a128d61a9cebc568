"""What the port does not do yet, and the ROADMAP.md item that brings it."""

ROADMAP_ITEMS = {
    "multi-device": "queue 1 item 7, multi-device",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error to raise for ``what``, naming its ROADMAP.md item."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {ROADMAP_ITEMS[item]})")
