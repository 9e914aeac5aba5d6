"""SentencePiece-style tokenizer over a GGUF vocab.

The port's own copy of `gemma_tpu/tokenizer/sentencepiece.py`;
tests/test_torch_gguf.py holds the two equal. It implements both directions
from the GGUF arrays
(`tokenizer.ggml.{tokens,scores,token_type}`):

* encode: SPM bigram-merge — start from UTF-8 characters, repeatedly merge
  the adjacent pair whose concatenation is the highest-scoring vocab piece
  (llama.cpp-compatible for "llama"-model vocabs, which Gemma uses);
  CONTROL / USER_DEFINED tokens (``<start_of_turn>``, ...) are matched
  literally first and emitted as single ids — they never byte-merge;
* decode: piece lookup with ``▁``→space and ``<0xXX>`` byte-token handling
  (generalizing remove_wunderline, gemma_model.cpp:753-760);
* O(1) piece→id hash map instead of the reference's linear scan
  (find_token_id, gemma_model.cpp:785-793).
"""
from __future__ import annotations

import dataclasses
import heapq

from ..gguf.constants import Keys, TokenType
from ..gguf.reader import GGUFReader

_SPACE = "▁"  # ▁


@dataclasses.dataclass
class SpecialTokens:
    bos: int = -1
    eos: int = -1
    unk: int = -1
    pad: int = -1


class Tokenizer:
    def __init__(
        self,
        pieces: list[str],
        scores: list[float],
        types: list[int],
        special: SpecialTokens,
        add_bos: bool = True,
        add_space_prefix: bool = True,
    ):
        self.pieces = pieces
        self.scores = scores
        self.types = types
        self.special = special
        self.add_bos = add_bos
        self.add_space_prefix = add_space_prefix
        self.piece_to_id = {p: i for i, p in enumerate(pieces)}
        self.byte_to_id = {}
        # special pieces matched literally in encode(), longest first so
        # e.g. <start_of_turn> wins over a hypothetical <start> prefix
        self.special_pieces: list[tuple[str, int]] = []
        for i, (p, t) in enumerate(zip(pieces, types)):
            if t == TokenType.BYTE and len(p) == 6 and p.startswith("<0x"):
                self.byte_to_id[int(p[3:5], 16)] = i
            elif t in (TokenType.CONTROL, TokenType.USER_DEFINED) and p:
                self.special_pieces.append((p, i))
        self.special_pieces.sort(key=lambda e: -len(e[0]))

    @classmethod
    def from_gguf(cls, reader: GGUFReader) -> "Tokenizer":
        pieces = list(reader.kv(Keys.TOKENS))
        scores = [float(s) for s in reader.kv(Keys.SCORES, [0.0] * len(pieces))]
        types = [int(t) for t in reader.kv(Keys.TOKEN_TYPE, [1] * len(pieces))]
        special = SpecialTokens(
            bos=int(reader.kv(Keys.BOS_ID, -1)),
            eos=int(reader.kv(Keys.EOS_ID, -1)),
            unk=int(reader.kv(Keys.UNK_ID, -1)),
            pad=int(reader.kv(Keys.PAD_ID, -1)),
        )
        return cls(
            pieces, scores, types, special,
            add_bos=bool(reader.kv(Keys.ADD_BOS, True)),
            add_space_prefix=bool(reader.kv(Keys.ADD_SPACE_PREFIX, True)),
        )

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # -- encode ------------------------------------------------------------
    def encode(self, text: str, *, add_bos: bool | None = None) -> list[int]:
        """Encode text; CONTROL/USER_DEFINED pieces present verbatim in the
        text (chat-template markers like <start_of_turn>) are emitted as
        their single token id, and only the spans between them run the SPM
        merge. The leading ▁ follows tokenizer.ggml.add_space_prefix (Gemma
        GGUFs export false) and is applied once, at the start of the text,
        never after a special token."""
        add_bos = self.add_bos if add_bos is None else add_bos
        ids: list[int] = []
        if add_bos and self.special.bos >= 0:
            ids.append(self.special.bos)
        if not text:
            return ids

        for seg_text, special_id, at_start in self._split_specials(text):
            if special_id is not None:
                ids.append(special_id)
            else:
                ids.extend(self._encode_segment(seg_text, at_start))
        return ids

    def _split_specials(self, text: str):
        """Yield (segment, special_id, at_text_start) covering `text`."""
        pos = 0
        at_start = True
        while pos < len(text):
            hit = None
            for piece, tid in self.special_pieces:
                nxt = text.find(piece, pos)
                if nxt >= 0 and (hit is None or nxt < hit[0]):
                    hit = (nxt, piece, tid)
            if hit is None:
                yield text[pos:], None, at_start
                return
            start, piece, tid = hit
            if start > pos:
                yield text[pos:start], None, at_start
            yield piece, tid, False
            pos = start + len(piece)
            at_start = False

    def _encode_segment(self, text: str, at_text_start: bool) -> list[int]:
        norm = text.replace(" ", _SPACE)
        if at_text_start and self.add_space_prefix:
            norm = _SPACE + norm
        if not norm:
            return []

        # symbols: list of (string, alive) merged in place via linked list
        sym = list(norm)
        prev = list(range(-1, len(sym) - 1))
        nxt = list(range(1, len(sym) + 1))
        nxt[-1] = -1

        def pair_entry(i: int):
            j = nxt[i]
            if j < 0:
                return None
            merged = sym[i] + sym[j]
            tid = self.piece_to_id.get(merged)
            if tid is None:
                return None
            # max-score merge; tie-break on leftmost (i) then shorter
            return (-self.scores[tid], i, len(merged), merged)

        heap = []
        for i in range(len(sym)):
            e = pair_entry(i)
            if e:
                heapq.heappush(heap, e)

        alive = [True] * len(sym)
        while heap:
            negs, i, mlen, merged = heapq.heappop(heap)
            j = nxt[i] if i < len(nxt) else -1
            if not alive[i] or j < 0 or not alive[j] or sym[i] + sym[j] != merged:
                continue  # stale entry
            sym[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prev[nxt[j]] = i
            for cand in (prev[i], i):
                if cand >= 0 and alive[cand]:
                    e = pair_entry(cand)
                    if e:
                        heapq.heappush(heap, e)

        out: list[int] = []
        i = 0
        while i >= 0:
            if alive[i]:
                tid = self.piece_to_id.get(sym[i])
                if tid is not None and self.types[tid] != TokenType.UNUSED:
                    out.append(tid)
                else:
                    out.extend(self._byte_fallback(sym[i]))
            i = nxt[i]
        return out

    def _byte_fallback(self, piece: str) -> list[int]:
        out = []
        for b in piece.encode("utf-8"):
            tid = self.byte_to_id.get(b)
            if tid is not None:
                out.append(tid)
            elif self.special.unk >= 0:
                out.append(self.special.unk)
        return out

    # -- decode ------------------------------------------------------------
    def decode_piece(self, token_id: int) -> str | bytes:
        p = self.pieces[token_id]
        t = self.types[token_id]
        if t == TokenType.BYTE and len(p) == 6 and p.startswith("<0x"):
            return bytes([int(p[3:5], 16)])
        if t in (TokenType.CONTROL, TokenType.UNKNOWN):
            return ""
        return p.replace(_SPACE, " ")

    def decode(self, ids: list[int]) -> str:
        buf = bytearray()
        for i in ids:
            piece = self.decode_piece(int(i))
            if isinstance(piece, bytes):
                buf.extend(piece)
            else:
                buf.extend(piece.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")
