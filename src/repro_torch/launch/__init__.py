"""Launch layer: the serving and training CLIs, execution plans and
roofline-term extraction (the dry-run and the mesh wait for their
slice)."""
