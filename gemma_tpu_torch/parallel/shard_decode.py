"""Tensor parallelism with explicit collectives: Megatron shards and `TPEngine`.

Counterpart of `gemma_tpu/parallel/shard_decode.py` on `torch.distributed`.
Each rank of a `sharding.Mesh` holds a self-contained Megatron shard of the
model, the port's CUDA kernels run on those shard-local weights unchanged,
and the only traffic of a forward is on the model axis: one all-reduce
after attn_output and one after ffn_down a layer and one after the
embedding gather (`models.gemma`'s `tp` hook), and one all-gather of the
logits.

Sharding plan (tp = the model axis's size, shard i = this rank's index):
  attn_q / ffn_gate / ffn_up   row-sharded, re-fused per shard into
                               attn_qkv / ffn_gate_up where the formats
                               match (q4_k_m's q6_k attn_v stays apart)
  attn_k / attn_v              row-sharded when n_kv_heads % tp == 0; else
                               shard i owns the ONE KV head its query heads
                               use, duplicated across shards (the Megatron
                               GQA rule, `_check_tp`)
  attn_output / ffn_down       column-sharded (K) at whole quant blocks ->
                               all-reduce; a shard that would cut a block
                               raises
  embed (tied head)            ceil(V / tp) vocab rows a shard, zero rows
                               past V (the port does not pad the vocab);
                               masked gather + all-reduce in, logits
                               all-gather out, sliced back to V
  norms                        replicated
  KV cache                     this data group's batch rows and this shard's
                               KV heads (int8 scales are head-local, so each
                               shard quantizes its own heads); the paged
                               pool needs a data axis of 1

Data axis: every rank runs the same Scheduler on the global batch (SPMD);
a data group computes only its rows (where the batch divides; else every
group computes all of them). A cache's `length` stays global [B] on every
rank; logits are [B, vocab] with this group's rows filled and the others
zero. The forward sends nothing over the data axis: only the sampled token
ids (B int32) are all-gathered over it, so that every rank takes the same
scheduling decisions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import gemma
from ..models.config import GemmaConfig
from ..quant.qtensor import QTensor, concat_rows, select_cols, select_rows
from ..runtime.engine import EngineConfig, prefill_len
from ..runtime.kv_cache import KVCache, to_device
from ..runtime.paged_kv import PagedKVCache
from ..runtime.sampler import SamplingParams, sample
from .sharding import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh


def _check_tp(cfg: GemmaConfig, tp: int) -> bool:
    """True when KV heads shard evenly; False when each shard instead owns
    ONE (possibly duplicated) KV head: the Megatron GQA rule, which needs
    tp % n_kv_heads == 0 so a shard's query heads map to one KV head."""
    if cfg.n_kv_heads % tp == 0:
        return True
    if tp % cfg.n_kv_heads != 0 or cfg.n_heads % tp != 0:
        raise ValueError(f"tp={tp} incompatible with heads {cfg.n_heads}/{cfg.n_kv_heads}")
    return False


def vocab_rows(cfg: GemmaConfig, tp: int) -> int:
    """Embedding rows a shard: ceil(V / tp), the last shard zero-padded."""
    return -(-cfg.vocab_size // tp)


def local_config(cfg: GemmaConfig, tp: int) -> GemmaConfig:
    """Per-shard geometry of the tensor-parallel forward."""
    kv_shard = _check_tp(cfg, tp)
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"tp={tp} does not divide n_heads {cfg.n_heads} and d_ff {cfg.d_ff}")
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp if kv_shard else 1,
        d_ff=cfg.d_ff // tp,
        vocab_size=vocab_rows(cfg, tp),
    )


def cache_heads(cfg: GemmaConfig, tp: int) -> int:
    """KV-head slots of the GLOBAL sharded cache: one local-head block a
    shard (duplicated heads get duplicated slots)."""
    return cfg.n_kv_heads if _check_tp(cfg, tp) else tp


def _slice_rows(w, lo: int, hi: int):
    """Out-feature rows [lo, hi) of a QTensor or a dense [out, in] matrix."""
    if isinstance(w, QTensor):
        return select_rows(w, slice(lo, hi))
    return w[lo:hi].contiguous()


def _slice_cols(w, lo: int, hi: int):
    """In-features [lo, hi): a QTensor at whole blocks (else raises)."""
    if isinstance(w, QTensor):
        return select_cols(w, lo, hi)
    return w[:, lo:hi].contiguous()


def _one_format(ws) -> bool:
    """All of `ws` dense, or QTensors of one format: they fuse by rows."""
    return len({w.fmt if isinstance(w, QTensor) else "dense" for w in ws}) == 1


def _shard_part(w, mode, tp: int, i: int):
    """Shard i's rows of w: "even" splits rows 1/tp; ("head", n_heads,
    head_dim) gives shard i the single head its query heads map to."""
    n = w.shape[0]
    if mode == "even":
        return _slice_rows(w, i * n // tp, (i + 1) * n // tp)
    _, n_heads, head_dim = mode
    h = i * n_heads // tp
    return _slice_rows(w, h * head_dim, (h + 1) * head_dim)


def _shard_rows_refused(ws: list, tp: int, i: int):
    """Row-shard several projections of one format and re-fuse them PER
    SHARD: shard i's fused weight (`ws`: (weight, mode) pairs, modes as
    `_shard_part`). The reference returns the permuted global weight whose
    contiguous 1/tp row blocks are these."""
    parts = [_shard_part(w, mode, tp, i) for w, mode in ws]
    return concat_rows(parts) if isinstance(parts[0], QTensor) else torch.cat(parts)


def _pad_rows(w, n: int):
    """w with zero rows appended up to n rows (zero bytes dequantize to 0
    in every format: each block's scale is 0)."""
    extra = n - w.shape[0]
    if extra == 0:
        return w
    if isinstance(w, QTensor):
        return QTensor(w.fmt, **{k: torch.cat([a, a.new_zeros(extra, *a.shape[1:])])
                                 for k, a in w.arrays.items()})
    return torch.cat([w, w.new_zeros(extra, *w.shape[1:])])


def shard_vocab(w, cfg: GemmaConfig, tp: int, i: int):
    """Shard i's vocab rows of the embedding / head: rows [i*n, (i+1)*n) of
    n = ceil(V / tp), zero rows past V."""
    n = vocab_rows(cfg, tp)
    return _pad_rows(_slice_rows(w, min(i * n, cfg.vocab_size), min((i + 1) * n, cfg.vocab_size)),
                     n)


def _split(w, at: list[int]):
    bounds = [0, *at, w.shape[0]]
    return [_slice_rows(w, lo, hi) for lo, hi in zip(bounds, bounds[1:])]


def shard_layer(lp: dict, cfg: GemmaConfig, tp: int, i: int) -> dict:
    """Shard i's weights of one layer (`lp`: the layer's weights by GGUF
    short name, norms as 1-D tensors): q|k|v and gate|up row-sharded and
    re-fused per shard where their formats match, attn_output and ffn_down
    column-sharded, norms replicated."""
    kv_shard = _check_tp(cfg, tp)
    out = {k: v for k, v in lp.items() if not isinstance(v, QTensor) and v.dim() == 1}
    if "attn_qkv" in lp:
        q, k, v = _split(lp["attn_qkv"], [cfg.q_dim, cfg.q_dim + cfg.kv_dim])
    else:
        q, k, v = lp["attn_q"], lp["attn_k"], lp["attn_v"]
    kv_mode = "even" if kv_shard else ("head", cfg.n_kv_heads, cfg.head_dim)
    if "ffn_gate_up" in lp:
        g, u = _split(lp["ffn_gate_up"], [cfg.d_ff])
    else:
        g, u = lp["ffn_gate"], lp["ffn_up"]
    for fused, names, ws in (("attn_qkv", ("attn_q", "attn_k", "attn_v"),
                              [(q, "even"), (k, kv_mode), (v, kv_mode)]),
                             ("ffn_gate_up", ("ffn_gate", "ffn_up"), [(g, "even"), (u, "even")])):
        if _one_format(w for w, _ in ws):
            out[fused] = _shard_rows_refused(ws, tp, i)
        else:  # q4_k_m's q6_k attn_v stays apart, as at load
            out.update((n, _shard_part(w, mode, tp, i)) for n, (w, mode) in zip(names, ws))
    kq, kf = cfg.q_dim // tp, cfg.d_ff // tp
    out["attn_output"] = _slice_cols(lp["attn_output"], i * kq, (i + 1) * kq)
    out["ffn_down"] = _slice_cols(lp["ffn_down"], i * kf, (i + 1) * kf)
    return out


def layer_weights(layer) -> dict:
    """A `DecoderLayer`'s weights by name (norms as their 1-D weights)."""
    out = dict(layer._buffers)
    for name, mod in layer._modules.items():
        out[name] = mod if isinstance(mod, QTensor) else mod.weight
    return out


def build_tp_params(params: gemma.Gemma, cfg: GemmaConfig, mesh: Mesh) -> gemma.Gemma:
    """This rank's shard of a whole model (`Gemma`, on any device), as a
    `Gemma` of `local_config` on the mesh's device, tagged `tp_shard =
    (index, tp)`. The slicing runs where `params` lies."""
    tp, i = mesh.model.size, mesh.model.index
    lcfg = local_config(cfg, tp)
    output = params.output if "output" in params._modules or "output" in params._buffers else None
    model = gemma.Gemma(
        lcfg,
        embed=shard_vocab(params.embed, cfg, tp, i),
        final_norm=params.final_norm.weight,
        layers=[shard_layer(layer_weights(l), cfg, tp, i) for l in params.layers],
        output=None if output is None else shard_vocab(output, cfg, tp, i),
    ).to(mesh.device)
    model.tp_shard = (i, tp)
    return model


def cache_specs(cfg: GemmaConfig, mesh: Mesh, batch: int, cache) -> dict:
    """The cache's placement by buffer: batch over data, head slots over
    model (the cache has `cache_heads` slots: one local block a shard).
    The paged pool is one global resource indexed by every sequence's page
    table: it shards over heads but cannot over data, so a data axis > 1
    raises."""
    tp, dp = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
    h = MODEL_AXIS if tp > 1 else None
    if isinstance(cache, PagedKVCache):
        if dp > 1:
            raise ValueError("paged TP caches require a data axis of 1")
        specs = {"k_pages": (None, h, None, None), "v_pages": (None, h, None, None),
                 "page_table": (None, None), "length": (None,)}
    else:
        b = DATA_AXIS if batch % dp == 0 and dp > 1 else None
        specs = {"k": (b, h, None, None), "v": (b, h, None, None), "length": (None,)}
    if cache.quantized:
        specs |= {"k_scale": specs.get("k", specs.get("k_pages"))[:3],
                  "v_scale": specs.get("k", specs.get("k_pages"))[:3]}
    return specs


class TPEngine:
    """Tensor-parallel engine over a mesh: prefill and decode with explicit
    collectives. Its surface is `runtime.Engine`'s (`prefill`,
    `decode_step`, `step`, `block`, `prefill_standalone`, `prefill_len`,
    `insert_sequence`, `new_cache`, `ecfg`, `device`) plus `place_cache`
    and `spec_verify`, so `runtime.Scheduler`, `SpecDecoder` and `serve`
    drive it unchanged: every rank of the mesh runs the same program on the
    same requests.

    `params` is the whole model (any device: `build_tp_params` cuts this
    rank's shard) or this rank's shard already (`tp_shard` set, as
    `testing.make_params(tp=...)` makes it). The rank runs on the mesh's
    device: the card unless the mesh was made on the CPU."""

    def __init__(self, cfg: GemmaConfig, params, mesh: Mesh | None = None,
                 max_seq_len: int = 512, max_batch: int = 1, kv_quantized: bool = False,
                 paged: bool = False, page_size: int | None = None, n_pages: int | None = None,
                 kv_dtype: torch.dtype = torch.bfloat16):
        mesh = mesh if mesh is not None else make_mesh()
        self.cfg, self.mesh = cfg, mesh
        self.tp, self.dp = mesh.model.size, mesh.data.size
        self.lcfg = local_config(cfg, self.tp)
        if paged and self.dp > 1:
            raise ValueError("paged TP serving requires a data axis of 1 (the page pool is a "
                             "single global resource; see cache_specs)")
        self.ecfg = EngineConfig(max_seq_len=max_seq_len, max_batch=max_batch, kv_dtype=kv_dtype,
                                 kv_quantized=kv_quantized, paged=paged, page_size=page_size,
                                 n_pages=n_pages)
        self.device = mesh.device
        if getattr(params, "tp_shard", None) == (mesh.model.index, self.tp):
            self.params = params.to(self.device)
        else:
            self.params = build_tp_params(params, cfg, mesh)

    # -- rows of the data axis ---------------------------------------------
    def _rows(self, batch: int) -> slice:
        """This data group's rows of a batch: all of them where the data
        axis is 1 or does not divide the batch."""
        if self.dp == 1 or batch % self.dp:
            return slice(0, batch)
        n = batch // self.dp
        return slice(self.mesh.data.index * n, (self.mesh.data.index + 1) * n)

    def _whole(self, rows: slice, batch: int) -> bool:
        return rows.stop - rows.start == batch

    def _global_logits(self, logits: torch.Tensor, rows: slice, batch: int) -> torch.Tensor:
        """[rows, V] -> [B, V], the other groups' rows zero."""
        if self._whole(rows, batch):
            return logits
        out = logits.new_zeros(batch, logits.shape[-1])
        out[rows] = logits
        return out

    def _gather_rows(self, t: torch.Tensor, rows: slice, batch: int) -> torch.Tensor:
        """This group's rows of token ids -> every group's [B, ...] (the
        data axis's only traffic)."""
        return t if self._whole(rows, batch) else self.mesh.data.all_gather(t, 0)

    def _forward(self, tokens, positions, cache, write_index, kv_limit, logits_at=None):
        """The shard-local forward, then the logits all-gathered over the
        model axis and sliced back to the vocab: [b, T, V] f32."""
        logits = gemma.forward(self.params, self.lcfg, tokens, positions, cache, write_index,
                               kv_limit, logits_at=logits_at, tp=self.mesh.model)
        return self.mesh.model.all_gather(logits, -1)[..., : self.cfg.vocab_size]

    # -- caches ------------------------------------------------------------
    def new_cache(self, batch: int | None = None, *, identity_pages: bool = True):
        """This rank's zeroed cache: its data group's rows (`length` stays
        [batch]) and its KV heads. `identity_pages` as `Engine.new_cache`."""
        e = self.ecfg
        batch = batch or e.max_batch
        if e.paged:
            n_pages = e.n_pages or batch * e.max_seq_len // e.page_size + 1
            return PagedKVCache.create(
                self.lcfg, batch, n_pages, page_size=e.page_size, max_seq_len=e.max_seq_len,
                dtype=e.kv_dtype, device=self.device, quantized=e.kv_quantized,
                identity_layout=identity_pages)
        rows = self._rows(batch)
        cache = KVCache.create(self.lcfg, rows.stop - rows.start, e.max_seq_len, dtype=e.kv_dtype,
                               device=self.device, quantized=e.kv_quantized)
        cache.length = torch.zeros(batch, dtype=torch.int32, device=self.device)
        return cache

    def place_cache(self, cache):
        """A cache on this rank's placement (`cache_specs`): one of
        `new_cache` as it is; a global one (`cache_heads` KV-head slots, the
        whole batch) cut to this rank's KV heads and rows."""
        paged = isinstance(cache, PagedKVCache)
        cache_specs(self.cfg, self.mesh, cache.length.shape[0], cache)  # a paged data axis raises
        first = (cache.k_pages if paged else cache.k)[0]
        lh, m = self.lcfg.n_kv_heads, self.mesh.model.index
        heads = slice(m * lh, (m + 1) * lh) if first.shape[1] == lh * self.tp != lh else slice(None)
        B = cache.length.shape[0]
        rows = slice(None)
        if not paged and first.shape[0] == B and not self._whole(self._rows(B), B):
            rows = self._rows(B)  # the whole batch: this data group's rows
        if rows == heads == slice(None):
            return cache
        for name in (("k_pages", "v_pages") if paged else ("k", "v")) + ("k_scale", "v_scale"):
            layers = getattr(cache, name)
            if layers is not None:
                setattr(cache, name, [b[rows, heads].contiguous().to(self.device) for b in layers])
        return cache

    # -- raw steps ---------------------------------------------------------
    @torch.no_grad()
    def prefill(self, prompts: list[list[int]], cache=None):
        """Right-pad a batch of prompts to the longest and run one forward.
        Returns (logits at each prompt's last token [B, vocab] f32, cache)."""
        B = len(prompts)
        lengths = [len(p) for p in prompts]
        T = max(lengths)
        if min(lengths) < 1 or T > self.ecfg.max_seq_len:
            raise ValueError(f"prompt lengths {lengths} must be in [1, max_seq_len="
                             f"{self.ecfg.max_seq_len}]")
        rows = self._rows(B)
        toks = np.zeros((B, T), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        toks = to_device(torch.from_numpy(toks[rows]), self.device)
        lengths_t = to_device(torch.tensor(lengths, dtype=torch.int32), self.device)
        lr = lengths_t[rows]
        positions = torch.arange(T, dtype=torch.int32, device=self.device).expand(len(lr), T)
        cache = cache if cache is not None else self.new_cache(B)
        logits = self._forward(toks, positions, cache, 0, lr, logits_at=lr - 1)
        cache.length = lengths_t
        return self._global_logits(logits[:, 0], rows, B), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens [B]: append one position per sequence; this group's rows
        only. Returns (logits [B, vocab] f32, cache). The write index is
        clamped to the last slot, as `Engine.decode_step` does."""
        B = cache.length.shape[0]
        rows = self._rows(B)
        lr = cache.length[rows]
        logits = self._forward(tokens.to(self.device)[rows, None], lr[:, None], cache,
                               lr.clamp(max=cache.max_len - 1), lr + 1)
        cache.advance(1)
        return self._global_logits(logits[:, 0], rows, B), cache

    @torch.no_grad()
    def step(self, logits: torch.Tensor, gen: torch.Generator | None, cache,
             sampling: SamplingParams = SamplingParams()):
        """Sample this group's rows, gather the token ids over the data
        axis, decode them. Every rank draws the whole batch's uniforms and
        keeps its rows' (`sampler.sample`), so the generators stay in step
        and each row of the batch gets its own noise. Returns (tokens [B]
        i32, next logits, cache)."""
        B = logits.shape[0]
        rows = self._rows(B)
        tok = self._gather_rows(sample(logits, sampling, gen, rows), rows, B)
        logits, cache = self.decode_step(tok, cache)
        return tok, logits, cache

    @torch.no_grad()
    def block(self, logits: torch.Tensor, gen: torch.Generator | None, cache, n: int,
              sampling: SamplingParams = SamplingParams()):
        """n fused sample+decode steps. Returns (tokens [B, n], logits, cache)."""
        toks = []
        for _ in range(n):
            tok, logits, cache = self.step(logits, gen, cache, sampling)
            toks.append(tok)
        return torch.stack(toks, dim=1), logits, cache

    @torch.no_grad()
    def spec_verify(self, toks: torch.Tensor, cache) -> torch.Tensor:
        """The speculative verify forward (`runtime.speculative.SpecDecoder`
        calls it in place of its own): toks [B, T] at each sequence's
        length, written into the cache; returns the greedy token after each
        row, [B, T] i32, gathered over the data axis. The decoder's
        acceptance and history stay replicated on every rank."""
        B, T = toks.shape
        rows = self._rows(B)
        lr = cache.length[rows]
        positions = lr[:, None] + torch.arange(T, dtype=torch.int32, device=self.device)
        logits = self._forward(toks[rows], positions, cache, lr, lr + T)
        return self._gather_rows(logits.argmax(dim=-1).to(torch.int32), rows, B)

    # -- prefill -> serving-cache hand-off ---------------------------------
    def prefill_len(self, prompt_len: int, pad_to: int | None = None) -> int:
        e = self.ecfg
        return prefill_len(prompt_len, 0, e.page_size if e.paged else None, pad_to)

    @torch.no_grad()
    def prefill_standalone(self, prompt: list[int], pad_to: int | None = None):
        """Prefill one sequence, batch-replicated (every data group computes
        it; TP still splits it), into a throwaway dense cache of this
        shard's heads; returns the `Engine`-compatible insert tuple."""
        T = self.prefill_len(len(prompt), pad_to)
        tmp = KVCache.create(self.lcfg, 1, T, dtype=self.ecfg.kv_dtype, device=self.device,
                             quantized=self.ecfg.kv_quantized)
        logits, tmp = self.prefill([prompt], cache=tmp)
        k_seq, v_seq, scales = tmp.extract_seq(0)
        return logits[0], k_seq, v_seq, scales, len(prompt)

    def insert_sequence(self, cache, slot: int, prefill_out, pages: list[int] | None = None):
        """Insert a `prefill_standalone` result into batch row `slot` (global)
        of this rank's cache: its K/V where the row is this group's, its
        length on every rank."""
        _, k_seq, v_seq, (k_sc, v_sc), length = prefill_out
        if isinstance(cache, PagedKVCache):
            return cache.insert_sequence(slot, pages, k_seq, v_seq, length, k_sc, v_sc)
        rows = self._rows(cache.length.shape[0])
        if self._whole(rows, cache.length.shape[0]):
            return cache.insert_sequence(slot, k_seq, v_seq, length, k_sc, v_sc)
        T = k_seq.shape[2]
        if T > cache.max_len:
            raise ValueError(f"prefill of {T} slots exceeds cache capacity {cache.max_len}")
        if rows.start <= slot < rows.stop:
            r = slot - rows.start
            for l in range(len(cache.k)):
                cache.k[l][r, :, :T] = k_seq[l]
                cache.v[l][r, :, :T] = v_seq[l]
                if cache.quantized:
                    cache.k_scale[l][r, :, :T] = k_sc[l]
                    cache.v_scale[l][r, :, :T] = v_sc[l]
        cache.length[slot] = length
        return cache

    # -- generation ----------------------------------------------------------
    @torch.no_grad()
    def generate_greedy(self, prompts: list[list[int]], max_new_tokens: int) -> np.ndarray:
        """Greedy tokens [B, max_new_tokens] of every prompt, on every rank."""
        logits, cache = self.prefill(prompts)
        if max_new_tokens > self.ecfg.max_seq_len - int(cache.length.max()):
            raise ValueError(f"max_new_tokens={max_new_tokens} exceeds the cache's capacity")
        out, _, _ = self.block(logits, None, cache, max_new_tokens)
        return out.cpu().numpy()
