"""Elastic scaling: move a training state between meshes (the port of
``repro.ft.resharding``).

Checkpoints store whole host arrays (ft/checkpoint.py), so elasticity
reduces to re-placement: build the sharding tree for the NEW mesh from
the same spec rules and place every leaf.  A job that loses a pod
restarts on the (2x smaller) mesh from the latest checkpoint with no
format conversion; scale-up is the same operation in reverse.
"""
from __future__ import annotations

from repro_torch.sharding.specs import NamedSharding, PartitionSpec as P
from repro_torch.sharding.specs import whole
from repro_torch.tree import tree_map, tree_map_with_path


def sharding_tree_for(tree, mesh, spec_fn) -> object:
    """Tree of ``NamedSharding``s; spec_fn(path, leaf) -> PartitionSpec."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_fn(path, leaf)), tree)


def replicated_tree(tree, mesh):
    return sharding_tree_for(tree, mesh, lambda path, leaf: P())


def reshard(tree, new_mesh, spec_fn=None):
    """Re-place a live tree onto a new mesh: each leaf gathered whole (a
    collective for a ``DTensor`` leaf: every rank of its mesh calls),
    then placed as a ``DTensor`` on ``new_mesh`` (every rank of the
    process group calls)."""
    spec_fn = spec_fn or (lambda path, leaf: P())
    target = sharding_tree_for(tree, new_mesh, spec_fn)
    return tree_map(
        lambda x, s: s.place(whole(x).to(new_mesh.device_type)),
        tree, target)
