"""One reader a metric: ``metrics/<name>.py`` defines ``read(ctx) -> float
| None`` (``run.Ctx``). A reader that finds nothing to read returns None and
the run leaves the metric out of its line."""
