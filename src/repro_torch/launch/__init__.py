"""Launch layer: the serving CLI (train, dry-run and the mesh wait for
their slices)."""
