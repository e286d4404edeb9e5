"""Launch layer: the serving and training CLIs, execution plans,
roofline-term extraction, the production mesh and the dry-run."""
