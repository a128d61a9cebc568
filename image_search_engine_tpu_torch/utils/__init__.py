"""Host utilities of the port. The framework-free ones (image decode,
thumbnails, path sidecars, serving stats) are imported from
``image_search_engine_tpu.utils`` instead of copied."""
