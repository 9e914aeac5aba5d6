from .constants import GGMLType, GGUFValueType, Keys, TokenType, block_size, row_size, type_size
from .reader import GGUFReader, TensorInfo
from .writer import GGUFWriter

__all__ = [
    "GGMLType",
    "GGUFValueType",
    "Keys",
    "TokenType",
    "GGUFReader",
    "GGUFWriter",
    "TensorInfo",
    "block_size",
    "row_size",
    "type_size",
]
