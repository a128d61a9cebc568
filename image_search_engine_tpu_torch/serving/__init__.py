"""Serving programs: feature prologue + search core + certificate epilogue."""
