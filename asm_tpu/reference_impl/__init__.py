"""Faithful scalar (NumPy) emulators of the reference C++ kernels.

These are the conformance oracles for the batched kernels: each module
mirrors the corresponding C++ algorithm step by step (citations inline), with
one deliberate, documented deviation — positions past a string's true end are
deterministic mismatches instead of reads of stale buffer memory
(hurdle_matrix.h:497 / LV_BAG.cpp:116 strncpy into reused fixed buffers).

They run one pair at a time in pure Python and exist only for tests; the
production path is the batched JAX kernels in asm_tpu.kernels.
"""

from asm_tpu.reference_impl.nw_ref import nw_ref
from asm_tpu.reference_impl.greedy_ref import greedy_ref
from asm_tpu.reference_impl.leap_ref import leap_ref

__all__ = ["nw_ref", "greedy_ref", "leap_ref"]
