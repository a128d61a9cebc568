"""Host utilities of the port: device selection, image decode and
thumbnails (copies of the JAX package's), serving stats, and the
not-ported-yet errors."""
