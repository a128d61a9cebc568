"""Single-device search helpers (the multi-device half waits for
ROADMAP.md queue 1 item 7)."""
