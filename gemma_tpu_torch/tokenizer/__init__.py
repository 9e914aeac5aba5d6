from .sentencepiece import SpecialTokens, Tokenizer

__all__ = ["Tokenizer", "SpecialTokens"]
