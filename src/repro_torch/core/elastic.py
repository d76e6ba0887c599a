"""The tile policy of ``repro.core.elastic``, for the card's planners.

The JAX module chooses TPU block shapes under a VMEM budget, by a static
model or, through :mod:`repro.tuning`, by measurement.  On Hopper each
kernel has its own planner (``kernels/kraken_gemm.py``,
``paged_attention.py``, ``kraken_moe_gemm.py``, ``kraken_conv.py``): a cost
model over that kernel's candidate plans, each capped at
:data:`SMEM_BUDGET` bytes of shared memory a block.  :func:`choose_tiles`
is the policy between the planner's pick and a measured one; the integer
helpers ``ceil_div`` and ``round_up`` are copied from the JAX module.
"""

from __future__ import annotations

#: shared memory one block may use on an H100 (bytes): the Hopper
#: counterpart of ``repro.core.elastic.VMEM_BUDGET``, read by every planner
SMEM_BUDGET = 227 * 1024

#: how a kernel call's plan is chosen: ``model`` the planner's pick,
#: ``cached`` a measured winner from the tile cache where it holds one (else
#: the planner's pick), ``autotune`` as ``cached`` but a miss is measured on
#: the card and persisted
TILE_MODES = ("model", "cached", "autotune")


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def choose_tiles(op_kind: str, shape: tuple, *, dtype_name: str, sms: int,
                 mode: str | None = None):
    """The choice a call of kernel ``op_kind`` (``gemm``, ``paged_decode``,
    ``moe_gemm``, ``conv_direct``) at ``shape`` on a card of ``sms`` SMs
    runs with: a tuple of the planner's choice fields, or None for the
    planner's own pick.

    ``mode`` is one of :data:`TILE_MODES`; None defers to the process-wide
    policy of :mod:`repro_torch.tuning` (default ``model``).  Under
    ``model`` nothing is looked up.  A choice that comes back is always one
    of the planner's candidates for ``shape``: the caller rebuilds the plan
    from it with the planner's ``plan(choice=...)``."""
    from repro_torch import tuning
    if mode is None:
        mode = tuning.get_tile_mode()
    if mode == "model":
        return None
    if mode not in TILE_MODES:
        raise ValueError(f"unknown tile mode: {mode!r}")
    return tuning.resolve_tiles(op_kind, shape, dtype_name=dtype_name,
                                sms=sms, mode=mode)
