"""Production mesh construction, as logical node contexts.

The JAX package's ``launch/mesh.py`` builds device meshes. On one card
the port's mesh is a :class:`~repro_torch.distributed.context.
MeshContext` of logical nodes (node axes as the leading dimensions of
every per-node tensor) on the device the caller names: ``None`` means
the card (and raises without one), ``"cpu"`` the plain versions,
``"meta"`` shapes only (``launch/dryrun.py``).
"""

from __future__ import annotations

from repro_torch.config import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.distributed.context import MeshContext, make_context


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> MeshContext:
    """The assignment's production meshes: 16x16 (256 nodes, one pod)
    or 2x16x16 (512 nodes, two pods)."""
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD, device=device)


def make_mesh(cfg: MeshConfig, device=None) -> MeshContext:
    return make_context(cfg.shape, cfg.axes, device=device)


#: logical nodes of the local mesh: the JAX package's tests and examples
#: run on 8 host devices
LOCAL_NODES = 8


def make_local_mesh(model_parallel: int = 1, device=None) -> MeshContext:
    """A (data, model) mesh of ``LOCAL_NODES`` logical nodes (the JAX
    package's mesh over whatever devices exist; examples and tests)."""
    if LOCAL_NODES % model_parallel:
        raise ValueError(f"{LOCAL_NODES} nodes not divisible by "
                         f"mp={model_parallel}")
    return make_context((LOCAL_NODES // model_parallel, model_parallel),
                        ("data", "model"), device=device)
