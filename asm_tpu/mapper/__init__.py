"""Read-mapper application (layer L5 of the reference).

Batched re-design of GASMA/mapper/ (my-indexer + my-mapper,
indexer.cpp:23-93, main.cpp:26-163): the reference uses a SeqAn3
bi-FM-index to find candidate positions per read and rescores each
candidate window one at a time with hurdle_matrix; here the candidate
windows of a WHOLE READ BATCH are gathered host-side from the native
FM-index (asm_tpu.native, pigeonhole exact seeding) and rescored in one
batched greedy_align launch on the device, then emitted as SAM.
"""

from asm_tpu.mapper.core import build_index, map_reads, MapperConfig

__all__ = ["build_index", "map_reads", "MapperConfig"]
