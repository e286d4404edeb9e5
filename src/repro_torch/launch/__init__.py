"""Launch layer: the serving CLI, execution plans and roofline-term
extraction (train, dry-run and the mesh wait for their slices)."""
