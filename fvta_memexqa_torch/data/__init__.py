from fvta_memexqa_torch.data.schema import Album, QAPair, parse_album_info, parse_qas
from fvta_memexqa_torch.data.tokenize import tokenize, word_to_char_ids
from fvta_memexqa_torch.data.vocab import Vocab, load_glove
from fvta_memexqa_torch.data.pack import PackedDataset, PackedShared, load_pack, pack
from fvta_memexqa_torch.data.device_prepro import (Batch, ModelInputs, SharedTables,
                                                   assemble, assemble_albums)
from fvta_memexqa_torch.data.synthetic import (focal_kind, make_evidence_only_synthetic,
                                               make_focal_synthetic, make_synthetic,
                                               write_raw_files)

__all__ = [
    "Album",
    "QAPair",
    "parse_album_info",
    "parse_qas",
    "tokenize",
    "word_to_char_ids",
    "Vocab",
    "load_glove",
    "PackedDataset",
    "PackedShared",
    "load_pack",
    "pack",
    "Batch",
    "ModelInputs",
    "SharedTables",
    "assemble",
    "assemble_albums",
    "focal_kind",
    "make_evidence_only_synthetic",
    "make_focal_synthetic",
    "make_synthetic",
    "write_raw_files",
]
