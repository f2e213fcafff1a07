"""The language model of every family: the port of
``repro/models/lm.py``.

  dense   [attn + mlp] x L                       (yi, qwen3, llama3.2,
                                                  stablelm)
  moe     every ``moe_every``-th block MoE       (dbrx: all, llama4:
                                                  alternating dense/MoE)
  vlm     groups of self blocks + 1 gated cross  (llama3.2-vision:
                                                  32 self + 8 cross)
  audio   encoder-only dense, frame inputs       (hubert)
  rwkv    [time-mix + channel-mix] x L           (rwkv6)
  hybrid  mamba2 stacks + shared attn block      (zamba2)

``LM`` is an ``nn.Module`` that holds its parameters (none requires a
gradient until ``layers.trainable``) under the reference's names, block
``i`` of the reference's stacked ``blocks`` tree being ``blocks.i``: the moe
family's ``blocks.i`` (``moe_every`` 1) or ``dense_blocks.i`` and
``moe_blocks.i`` (``moe_every`` 2, layer 2i dense with ``d_ff_dense``
and 2i+1 MoE); the vlm family's ``self_blocks`` (``[n_cross, per_group,
...]`` in the reference) are ``self_blocks.g.j`` and its
``cross_blocks.g``; the audio family has ``in_proj [d, d]`` in place of
``embed``; the hybrid family's ``mamba_groups`` are ``mamba_groups.g.j``,
its ``mamba_tail`` is ``mamba_tail.i`` and its ``shared_attn`` one
``DenseBlock`` (``models.convert`` carries a JAX parameter tree across).
``loss`` is the training objective (``layers.trainable`` makes the
parameters require grad); ``_backbone`` wraps each block's body in
``transformer.remat`` under ``cfg.remat_policy``, where the reference
wraps its scan body.

Caches are stacked along leading axes as in the reference
(``KVCache`` with ``k [L, B, S, H, Dh]``, and the int8 cache's scales
``[L, B, S, H, 1]``, for the dense and moe families, a moe model with
``moe_every`` 2 interleaving its dense and MoE layers' caches; the vlm
family's dict of ``self`` (``KVCache`` ``[n_self, ...]``) and
``cross_k``/``cross_v`` ``[n_cross, B, n_img_tokens, H, Dh]``, the
image tokens' keys and values that the cross blocks read in decode;
``RWKVCache`` with ``state [L, B, H, dk, dv]``; the hybrid family's dict
of ``mamba_groups`` (``SSMCache`` ``[n_groups, every, ...]``),
``shared_attn`` (``KVCache`` ``[n_groups, ...]``, one per application of
the shared block) and ``mamba_tail``).  The audio encoder has no decode
caches and does not decode.  With a sliding window the attention cache
holds ``min(window, seq)`` slots and is written as a ring (``_slot``).
``decode_step`` updates the caches in place and returns them.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from ..device import resolve
from ..parallel import sharding
from . import attention as attn_mod
from . import layers, rwkv as rwkv_mod, ssm as ssm_mod
from . import transformer as tf
from .config import ModelConfig, ShapeSpec

FAMILIES = ("dense", "moe", "vlm", "audio", "rwkv", "hybrid")


def _map(fn, cache):
    """``fn`` applied to every tensor of a cache NamedTuple; the absent
    scales of a bf16 or float32 ``KVCache`` stay ``None``."""
    return type(cache)(*(None if a is None else fn(a) for a in cache))


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


class LM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check(cfg)
        self.cfg = cfg
        dev = resolve(device)
        dt = layers.dtype_of(cfg.param_dtype)
        d, L = cfg.d_model, cfg.n_layers
        if cfg.family == "audio":
            self.in_proj = layers.param((d, d), dt, dev)
        else:
            self.embed = layers.param((cfg.vocab, d), dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = layers.param((d, cfg.vocab), dt, dev)
        self.ln_f = layers.param((d,), dt, dev)
        if cfg.family == "moe" and cfg.moe_every != 1:
            if cfg.moe_every != 2 or L % 2:
                raise ValueError(f"moe_every={cfg.moe_every} with "
                                 f"{L} layers: the reference takes 1, or 2 "
                                 f"with an even depth")
            self.dense_blocks = tf.stack_init(L // 2, lambda: tf.DenseBlock(
                cfg, dev, d_ff=cfg.d_ff_dense))
            self.moe_blocks = tf.stack_init(
                L // 2, lambda: tf.MoEBlock(cfg, dev))
        elif cfg.family == "vlm":
            n_cross, per_group = vlm_layout(cfg)
            self.self_blocks = tf.stack_init(n_cross, lambda: tf.stack_init(
                per_group, lambda: tf.DenseBlock(cfg, dev)))
            self.cross_blocks = tf.stack_init(
                n_cross, lambda: tf.CrossBlock(cfg, dev))
        elif cfg.family == "hybrid":
            n_groups, every, tail = hybrid_layout(cfg)
            self.mamba_groups = tf.stack_init(n_groups, lambda: tf.stack_init(
                every, lambda: tf.MambaBlock(cfg, dev)))
            if tail:
                self.mamba_tail = tf.stack_init(
                    tail, lambda: tf.MambaBlock(cfg, dev))
            self.shared_attn = tf.shared_attn_block(cfg, dev)
        else:
            block = {"dense": tf.DenseBlock, "audio": tf.DenseBlock,
                     "moe": tf.MoEBlock, "rwkv": tf.RWKVBlock}[cfg.family]
            self.blocks = tf.stack_init(L, lambda: block(cfg, dev))

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random initialisation from ``generator`` (on the model's
        device), with the reference's distributions: truncated normals
        at fan-in scale, ones for norms, zeroed padded-head rows, the
        Mamba2 mixers' own (``ssm.Mamba2.init``), the MoE layers' experts
        at their own fan-in, the cross blocks' gates at 0."""
        if self.cfg.family == "audio":
            layers.dense_init(self.in_proj, generator)
        else:
            layers.embed_init(self.embed, generator)
        if not self.cfg.tie_embeddings:
            layers.dense_init(self.lm_head, generator)
        with torch.no_grad():
            self.ln_f.fill_(1)
        if self.cfg.family == "hybrid":
            blocks = [*(b for g in self.mamba_groups for b in g),
                      *getattr(self, "mamba_tail", ()), self.shared_attn]
        elif self.cfg.family == "vlm":
            blocks = [*(b for g in self.self_blocks for b in g),
                      *self.cross_blocks]
        elif hasattr(self, "moe_blocks"):
            blocks = [*self.dense_blocks, *self.moe_blocks]
        else:
            blocks = self.blocks
        for blk in blocks:
            blk.init(generator)
        return self

    # ------------------------------------------------------------------
    # input embedding / unembedding
    # ------------------------------------------------------------------
    def _embed(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Token embeddings, or the audio family's frame embeddings
        ``batch["frames"] [B, S, d]`` in the compute dtype times
        ``in_proj`` (on a mesh, the rank's columns all-gathered)."""
        if self.cfg.family == "audio":
            dt = layers.dtype_of(self.cfg.compute_dtype)
            return sharding.tp_gather_last(batch["frames"].to(dt) @
                                           self.in_proj,
                                           layers.model_split(self.in_proj))
        return self._lookup(batch["tokens"])

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """``embed[tokens]``; on a mesh a vocabulary-parallel lookup: the
        rank's rows give the ids in its range and zeros elsewhere, summed
        over ``model`` (exact: one term is not zero)."""
        tp = layers.model_split(self.embed)
        if tp is None:
            return self.embed[tokens]
        vl = self.embed.shape[0]
        t = tokens.long() - tp.index * vl
        inside = ((t >= 0) & (t < vl))[..., None]
        rows = self.embed[t.clamp(0, vl - 1)]
        return sharding.tp_reduce(
            torch.where(inside, rows, torch.zeros_like(rows)), tp)

    def _head(self):
        """(the ``[d, V]`` head, ``embed.T`` with tied embeddings; its
        ``TP`` where the rank holds a slice of the vocabulary)."""
        if self.cfg.tie_embeddings:
            return self.embed.T, layers.model_split(self.embed)
        return self.lm_head, layers.model_split(self.lm_head)

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``[..., V]``, or the rank's vocabulary slice on a mesh."""
        head, tp = self._head()
        return sharding.tp_copy(x, tp) @ head

    # ------------------------------------------------------------------
    # backbone (full sequence)
    # ------------------------------------------------------------------
    def _backbone(self, x: torch.Tensor, positions: torch.Tensor,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The blocks over the full sequence -> (x, aux): aux is the mean
        of the MoE layers' load-balance losses (0 for the other
        families); ``batch["img"] [B, T, d]`` is the vlm family's cross
        source."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def wrap(body):
            def run(x, *blks):
                with sharding.local_shards(*blks):
                    return body(x, *blks)
            return tf.remat(run, cfg.remat_policy)

        def pin(y):
            return sharding.constrain_act(y) if cfg.act_constraints else y

        @wrap
        def dense(x, blk):
            return pin(tf.dense_block(blk, cfg, x, positions)[0])

        x = pin(x)
        if cfg.family in ("dense", "audio"):
            for blk in self.blocks:
                x = dense(x, blk)
        elif cfg.family == "moe":
            auxs = []
            if cfg.moe_every == 1:
                @wrap
                def body(x, blk):
                    y, _, a = tf.moe_block(blk, cfg, x, positions)
                    return pin(y), a
                for blk in self.blocks:
                    x, a = body(x, blk)
                    auxs.append(a)
            else:
                @wrap
                def body(x, dblk, mblk):
                    y, _ = tf.dense_block(dblk, cfg, x, positions)
                    y, _, a = tf.moe_block(mblk, cfg, pin(y), positions)
                    return pin(y), a
                for dblk, mblk in zip(self.dense_blocks, self.moe_blocks):
                    x, a = body(x, dblk, mblk)
                    auxs.append(a)
            aux = torch.stack(auxs).mean()
        elif cfg.family == "vlm":
            img = batch["img"].to(x.dtype)

            @wrap
            def self_block(x, blk):
                return tf.dense_block(blk, cfg, x, positions)[0]
            for selfs, cross in zip(self.self_blocks, self.cross_blocks):
                for blk in selfs:
                    x = self_block(x, blk)
                with sharding.local_shards(cross):
                    x = tf.cross_block(cross, cfg, x, img, positions)
        elif cfg.family == "rwkv":
            @wrap
            def body(x, blk):
                h, _, _ = rwkv_mod.time_mix_forward(
                    blk.time, cfg, layers.rmsnorm(x, blk.ln1, cfg.norm_eps),
                    pin=pin if cfg.act_constraints else None)
                y = pin(x + h)
                h2, _ = rwkv_mod.channel_mix_forward(
                    blk.chan, cfg, layers.rmsnorm(y, blk.ln2, cfg.norm_eps))
                return pin(y + h2)
            for blk in self.blocks:
                x = body(x, blk)
        else:
            @wrap
            def mamba(x, blk):
                h, _ = ssm_mod.mamba2_forward(
                    blk.ssm, cfg, layers.rmsnorm(x, blk.ln, cfg.norm_eps))
                return x + h
            for group in self.mamba_groups:
                for blk in group:
                    x = mamba(x, blk)
                with sharding.local_shards(self.shared_attn):
                    x, _ = tf.dense_block(self.shared_attn, cfg, x, positions)
            for blk in getattr(self, "mamba_tail", ()):
                x = mamba(x, blk)
        return x, aux

    # ------------------------------------------------------------------
    # loss (training step objective)
    # ------------------------------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training objective (``repro/models/lm.py:211-229``): the
        cross-entropy of ``batch["labels"]`` (over ``batch["loss_mask"]``
        where given; chunked over the sequence with ``cfg.ce_chunk``) plus
        0.01 times the MoE load-balance loss.  Returns (total, {"ce",
        "aux", "tokens"}), all float32.  Parameters stored as DTensors
        (``sharding.shard_params``) read as their local shards
        (``sharding.local_shards``): the top-level ones for the whole call,
        each block's around its body; the vocabulary is split over
        ``model`` and so is the cross-entropy's sum (``layers._nll``)."""
        with sharding.local_shards(self, recurse=False):
            return self._loss(batch)

    def _loss(self, batch):
        cfg = self.cfg
        x = self._embed(batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._backbone(x, positions, batch)
        x = layers.rmsnorm(x, self.ln_f, cfg.norm_eps)
        mask = batch.get("loss_mask")
        head, tp = self._head()
        if cfg.ce_chunk:
            ce, count = layers.chunked_cross_entropy(
                x, head, batch["labels"], cfg.ce_chunk, mask, tp=tp)
        else:
            ce, count = layers.softmax_cross_entropy(
                self._unembed(x), batch["labels"], mask, tp=tp)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "tokens": count}

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_len(self, seq_len: int) -> int:
        """Attention cache slots for a context of ``seq_len``: a sliding
        window caps them at the window (a ring)."""
        if self.cfg.sliding_window:
            return min(self.cfg.sliding_window, seq_len)
        return seq_len

    def init_caches(self, batch: int, seq_len: int):
        """Zeroed decode caches sized for a context of ``seq_len``,
        stacked along the reference's leading axes; the vlm family's
        cross caches are zeros until the caller writes the image tokens'
        keys and values into them.  The audio encoder raises.  On a mesh
        every leaf is a DTensor placed by ``sharding.cache_specs`` (the
        batch over the data axes, heads and channels over ``model``), and
        a rank allocates only its shard."""
        mesh = sharding.mesh_of(self.parameters())
        if mesh is None:
            return self._init_caches(batch, seq_len, self.device)
        _whole_batch(batch, mesh)
        glob = self._init_caches(batch, seq_len, "meta")
        specs = sharding.cache_specs(
            self.cfg, ShapeSpec("decode", seq_len, batch, "decode"), mesh,
            glob)
        sizes = sharding.axis_sizes(mesh)
        fill = {"pos": -1, "k_scale": 1, "v_scale": 1}

        def shard(path, spec):
            g = sharding._get(glob, path)
            shape = [d // sharding._axis_size(sizes, ax)
                     for d, ax in zip(g.shape, spec)]
            return torch.full(shape, fill.get(path[-1], 0), dtype=g.dtype,
                              device=self.device)

        return sharding.from_local_tree(sharding._tree_map(shard, specs),
                                        glob, specs, mesh)

    def _init_caches(self, batch: int, seq_len: int, dev):
        cfg = self.cfg

        def stack(lead, one):
            return _map(lambda a: a.expand(*lead, *a.shape).clone(), one)

        def kv():
            return attn_mod.init_cache(
                cfg, batch, self.cache_len(seq_len), kv_repeat=cfg.kv_repeat,
                cache_dtype=cfg.cache_dtype, device=dev)

        if cfg.family in ("dense", "moe"):
            return stack((cfg.n_layers,), kv())
        if cfg.family == "vlm":
            n_cross, per_group = vlm_layout(cfg)
            h = attn_mod.effective_kv_heads(cfg, cfg.kv_repeat)
            shape = (n_cross, batch, cfg.n_img_tokens, h, cfg.head_dim)
            dt = layers.dtype_of(cfg.compute_dtype)
            return {"self": stack((n_cross * per_group,), kv()),
                    "cross_k": torch.zeros(shape, dtype=dt, device=dev),
                    "cross_v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.family == "audio":
            raise ValueError(f"{cfg.family} has no decode caches")
        if cfg.family == "rwkv":
            return stack((cfg.n_layers,),
                         rwkv_mod.init_rwkv_cache(cfg, batch, device=dev))
        n_groups, every, tail = hybrid_layout(cfg)
        ssm = ssm_mod.init_ssm_cache(cfg, batch, device=dev)
        caches = {"mamba_groups": stack((n_groups, every), ssm),
                  "shared_attn": stack((n_groups,), kv())}
        if tail:
            caches["mamba_tail"] = stack((tail,), ssm)
        return caches

    # ------------------------------------------------------------------
    # decode step (one new token against an existing cache)
    # ------------------------------------------------------------------
    def decode_step(self, caches, token: torch.Tensor,
                    pos: Union[int, torch.Tensor]):
        """token ``[B, 1]`` int, pos an int (or a 0-d tensor) -> (logits
        ``[B, V]``, caches).  The caches are updated in place; the
        attention write slot is ``pos``, or ``pos % window`` in a ring
        (``_slot``).  On a mesh (DTensor parameters and ``init_caches``'
        DTensor caches) each rank decodes its rows of ``token`` with its
        heads, writes its shards of the caches, and the logits are a
        DTensor: rows over the data axes, the vocabulary over ``model``."""
        if self.cfg.family == "audio":
            raise ValueError(f"{self.cfg.family} does not decode")
        mesh = sharding.mesh_of(self.parameters())
        if mesh is None:
            return self._decode(caches, token, pos), caches
        with sharding.local_shards(self):
            logits = self._decode(sharding.local_tree(caches),
                                  sharding.local_rows(token, mesh), pos)
            return self._mesh_logits(logits, mesh), caches

    def _decode(self, caches, token: torch.Tensor, pos) -> torch.Tensor:
        cfg = self.cfg
        pos = int(pos)
        x = self._lookup(token)
        positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
        if cfg.family in ("dense", "moe"):
            slot = self._slot(pos, caches.k.shape[2])

            def layer(i):
                return _map(lambda a: a[i], caches)
            if cfg.family == "dense":
                for i, blk in enumerate(self.blocks):
                    x, _ = tf.dense_block(blk, cfg, x, positions,
                                          cache=layer(i), cache_pos=slot)
            elif cfg.moe_every == 1:
                for i, blk in enumerate(self.blocks):
                    x, _, _ = tf.moe_block(blk, cfg, x, positions,
                                           cache=layer(i), cache_pos=slot)
            else:
                # layer 2i dense, 2i+1 MoE, over the interleaved caches
                for i, (dblk, mblk) in enumerate(zip(self.dense_blocks,
                                                     self.moe_blocks)):
                    x, _ = tf.dense_block(dblk, cfg, x, positions,
                                          cache=layer(2 * i), cache_pos=slot)
                    x, _, _ = tf.moe_block(mblk, cfg, x, positions,
                                           cache=layer(2 * i + 1),
                                           cache_pos=slot)
        elif cfg.family == "vlm":
            selfc = caches["self"]
            slot = self._slot(pos, selfc.k.shape[2])
            per_group = vlm_layout(cfg)[1]
            for g, (selfs, cross) in enumerate(zip(self.self_blocks,
                                                   self.cross_blocks)):
                for j, blk in enumerate(selfs):
                    x, _ = tf.dense_block(
                        blk, cfg, x, positions, cache_pos=slot,
                        cache=_map(lambda a: a[g * per_group + j], selfc))
                h, _ = attn_mod.attention(
                    cross.xattn, cfg,
                    layers.rmsnorm(x, cross.ln1, cfg.norm_eps), positions,
                    kv_repeat=cfg.kv_repeat,
                    kv_override=(caches["cross_k"][g], caches["cross_v"][g]))
                x = tf.cross_residuals(cross, cfg, x, h)
        elif cfg.family == "rwkv":
            # shift windows sharded over model: gathered on use, the
            # rank's channels kept
            tp = sharding.tp_of(self.ln_f) \
                if caches.shift_t.shape[-1] != cfg.d_model else None
            for i, blk in enumerate(self.blocks):
                h, state, last_t = rwkv_mod.time_mix_decode(
                    blk.time, cfg, layers.rmsnorm(x, blk.ln1, cfg.norm_eps),
                    sharding.tp_gather_last(caches.shift_t[i], tp),
                    caches.state[i])
                y = x + h
                xn = layers.rmsnorm(y, blk.ln2, cfg.norm_eps)
                h2, last_c = rwkv_mod.channel_mix_forward(
                    blk.chan, cfg, xn,
                    cache_shift=sharding.tp_gather_last(caches.shift_c[i], tp))
                caches.shift_t[i].copy_(sharding.tp_split_last(last_t, tp))
                caches.shift_c[i].copy_(sharding.tp_split_last(last_c, tp))
                caches.state[i].copy_(state)
                x = y + h2
        else:
            attn = caches["shared_attn"]
            slot = self._slot(pos, attn.k.shape[2])

            def mamba(x, blk, cache):
                h, new = ssm_mod.mamba2_decode(
                    blk.ssm, cfg, layers.rmsnorm(x, blk.ln, cfg.norm_eps),
                    cache)
                for a, b in zip(cache, new):
                    a.copy_(b)
                return x + h

            groups = caches["mamba_groups"]
            for g, group in enumerate(self.mamba_groups):
                for j, blk in enumerate(group):
                    x = mamba(x, blk, _map(lambda a: a[g, j], groups))
                x, _ = tf.dense_block(
                    self.shared_attn, cfg, x, positions, cache_pos=slot,
                    cache=_map(lambda a: a[g], attn))
            for i, blk in enumerate(getattr(self, "mamba_tail", ())):
                x = mamba(x, blk, _map(lambda a: a[i], caches["mamba_tail"]))
        x = layers.rmsnorm(x, self.ln_f, cfg.norm_eps)
        return self._unembed(x)[:, 0, :]

    def _mesh_logits(self, logits: torch.Tensor, mesh) -> torch.Tensor:
        """A rank's last-token logits ``[B_local, V_local]`` as the DTensor
        ``[B, V]``: rows over the data axes, the vocabulary over ``model``
        where the head splits it (inside ``local_shards``)."""
        _, tp = self._head()
        spec = sharding.P(sharding.data_axes(mesh),
                          sharding.MODEL_AXIS if tp else None)
        n = sharding.data_shard(mesh)[1]
        glob = torch.empty((logits.shape[0] * n, self.cfg.vocab),
                           device="meta")
        return sharding.from_local_tree([logits], [glob], [spec], mesh)[0]

    def _slot(self, pos: int, cache_size: int) -> int:
        """The write slot of position ``pos``: ``pos % cache_size`` in a
        ring (a sliding window no shorter than the cache), else ``pos``."""
        if self.cfg.sliding_window and cache_size <= self.cfg.sliding_window:
            return pos % cache_size
        return pos

    # ------------------------------------------------------------------
    # prefill: full-sequence forward that also fills decode caches
    # ------------------------------------------------------------------
    def prefill(self, batch: Dict[str, torch.Tensor]):
        """Returns (last-token logits ``[B, V]``, caches ready for
        decode).  The dense family only, as in the reference (the others
        raise ``NotImplementedError``); the caches
        hold k and v in the compute dtype even for an int8
        ``cache_dtype``, as the reference's do.  On a mesh each rank
        takes its rows of the batch and computes its heads; the logits
        are a DTensor as ``decode_step``'s and the caches DTensors placed
        by ``sharding.cache_specs``."""
        cfg = self.cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                f"prefill for family {cfg.family} lives in "
                f"examples/serve_batch")
        mesh = sharding.mesh_of(self.parameters())
        if mesh is None:
            return self._prefill(batch)
        b = next(iter(batch.values())).shape[0]
        _whole_batch(b, mesh)
        with sharding.local_shards(self):
            logits, caches = self._prefill(
                {k: sharding.local_rows(v, mesh) for k, v in batch.items()})
            logits = self._mesh_logits(logits, mesh)
        L, _, s, h, dh = caches.k.shape
        k = torch.empty((L, b, s, cfg.n_kv_heads * cfg.kv_repeat, dh),
                        dtype=caches.k.dtype, device="meta")
        glob = attn_mod.KVCache(k, k, torch.empty(caches.pos.shape,
                                                  dtype=torch.int32,
                                                  device="meta"))
        specs = sharding.cache_specs(cfg, ShapeSpec("prefill", s, b,
                                                    "prefill"), mesh, glob)
        return logits, sharding.from_local_tree(caches, glob, specs, mesh)

    def _prefill(self, batch):
        cfg = self.cfg
        x = self._embed(batch)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        layer_caches = []
        for blk in self.blocks:
            x, nc = tf.dense_block(blk, cfg, x, positions, return_cache=True)
            layer_caches.append(nc)
        caches = attn_mod.KVCache(*(torch.stack(a) for a in
                                    zip(*(c[:3] for c in layer_caches))))
        x = layers.rmsnorm(x, self.ln_f, cfg.norm_eps)
        logits = self._unembed(x[:, -1:, :])[:, 0, :]
        return logits, caches


def _whole_batch(batch: int, mesh) -> None:
    """Raise unless the data axes split ``batch`` by rows: a batch that
    they do not divide shards the sequence (``long_500k``), which the port
    does not run."""
    n = sharding.data_shard(mesh)[1]
    if batch % n:
        raise NotImplementedError(
            f"a batch of {batch} over {n} data shards: sequence-sharded "
            f"attention is not ported")


def vlm_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(cross blocks, self blocks per group) of the vlm family: each
    group of self blocks is closed by one gated cross block
    (``repro/models/lm.py:71-82``)."""
    every = cfg.cross_attn_every
    n_cross = cfg.n_layers // every
    per_group = every - 1
    if cfg.n_layers - n_cross != n_cross * per_group:
        raise ValueError(f"vlm: {cfg.n_layers} layers are not groups of "
                         f"{per_group} self blocks and one cross block")
    return n_cross, per_group


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, Mamba2 blocks per group, tail blocks) of the hybrid
    family: each group is followed by one application of the shared
    attention block (``repro/models/lm.py:91-106``)."""
    every = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // every
    return n_groups, every, cfg.n_layers - n_groups * every
