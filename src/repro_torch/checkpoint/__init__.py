"""repro_torch.checkpoint — elastic re-sharding of the clustering engines'
sharded state (the checkpoint manager comes with ROADMAP.md A9)."""

from repro_torch.checkpoint.elastic import ParamSpec, reshard_rows, validate_mesh_for_tree

__all__ = ["ParamSpec", "reshard_rows", "validate_mesh_for_tree"]
