from soap3dp_tpu_torch.index.packing import PackedGenome, pack_fasta
from soap3dp_tpu_torch.index.builder import Index, build_index, load_index, save_index

__all__ = [
    "PackedGenome",
    "pack_fasta",
    "Index",
    "build_index",
    "load_index",
    "save_index",
]
