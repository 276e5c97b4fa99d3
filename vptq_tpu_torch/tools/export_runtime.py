"""Runtime checkpoints: a loaded model's runtime tensors, written once and
read back without re-encoding.

Port of ``vptq_tpu/tools/export_runtime.py``. Loading a VPTQ checkpoint
in a runtime format re-encodes every layer (exact dequant, scale search);
a calibrated format (``int2-mixed``, ``int3-mixed``, ``int4-mixed``) runs
GPTQ over the whole model (``quant/calibrate.py``). Such a file is made
once and read back without either. The format is the JAX package's, in
both directions:

  * ``runtime.safetensors``: the JAX key names (``wq`` / ``scales`` int8,
    ``wq4`` / ``scales4`` int4, ``wq3_2`` / ``wq3_1`` / ``scales3`` int3,
    ``wq2p`` / ``scales2`` int2, ``weight`` dense; a mixed layer's base
    under ``mix2`` or ``mix3``, its side under ``mix8``, its columns as
    int32 ``mix_cols``; a Mixtral or DeepSeek block's stacked experts
    under ``stacked_{int8,int4}``; MLA's ``kv_a_proj``, ``kv_a_norm``,
    ``q_a_norm``, the absorbed ``uk`` / ``uv``; DeepSeek's
    ``router_weight``, ``correction_bias`` and ``shared_experts``); bf16
    tensors written as U16;
  * ``runtime_config.json``: ``format_version`` 1, ``model_config`` (the
    fields of ``ModelConfig`` by the JAX names) and ``bf16_keys``, the
    tensors to view back as bf16.

The reader maps the file and copies each tensor to the device as it lies.
It refuses another ``format_version``, and blocked (``shards > 1``)
encodings, which the JAX package writes without a marker and reads with
no mesh: a plane whose padded width is not the one a one-device encoder
gives the layer's logical width (int8: a whole scale group; int4 and
int3: 2048; int2: 1024), or mixed columns that are not strictly
increasing inside that width. A blocked layer whose every shard already
has the one-device width has the one-device shape and cannot be told
apart, so the writer refuses a model that carries a blocked layer (one
tagged ``shards`` > 1 by its encoder): such a model is a placement
artifact of tensor parallelism, not a one-device file.

CLI (a VPTQ checkpoint re-encoded on the card, then written):

    python -m vptq_tpu_torch.tools.export_runtime -m CKPT -o OUT \\
        [--runtime-format int8] [--device cpu]

Load:

    model = vptq_tpu_torch.tools.export_runtime.load_runtime_model(OUT)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    Int2Linear,
    Int2MixedLinear,
    Int3Linear,
    Int3MixedLinear,
    Int4Linear,
    Int8Linear,
    _blocked,
)
from vptq_tpu_torch.models.llama import (
    Attention,
    Block,
    DeepseekMoe,
    MlaAttention,
    Mlp,
    Model,
    ModelConfig,
    MoeMlp,
    StackedExperts,
)
from vptq_tpu_torch.models.loader import (
    _check_supported,
    _read_safetensors,
    load_model,
    resolve_device,
    write_safetensors,
)
from vptq_tpu_torch.ops.packing import W2_BLOCK

__all__ = ["export_runtime", "load_runtime_model", "main"]

_FORMAT_VERSION = 1
# each layer type's (attribute, key) pairs, its first key marking it
_KEYS = {
    Int8Linear: (("wq", "wq"), ("scales", "scales")),
    Int4Linear: (("wq", "wq4"), ("scales", "scales4")),
    Int3Linear: (("wq2", "wq3_2"), ("wq1", "wq3_1"), ("scales", "scales3")),
    Int2Linear: (("wq", "wq2p"), ("scales", "scales2")),
    DenseLinear: (("weight", "weight"),),
}
_MIXED = {Int2MixedLinear: "mix2", Int3MixedLinear: "mix3"}
# the multiple a one-device encoder pads in_features to (int8: its group)
_PAD_TO = {Int4Linear: 2048, Int3Linear: 2048, Int2Linear: W2_BLOCK}
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj")
_MLP = ("gate_proj", "up_proj", "down_proj", "gate_up_proj")
_MLA = ("kv_a_proj", "o_proj", "q_proj", "q_a_proj", "q_b_proj")
_MLA_ARRAYS = ("kv_a_norm", "q_a_norm", "uk", "uv")
_STACKED = ("gate_up_wq", "gate_up_scales", "down_wq", "down_scales")


def _put(out: Dict[str, torch.Tensor], name: str, t) -> None:
    if t is not None:
        out[name] = t.detach().cpu().contiguous()


def _put_linear(out: Dict[str, torch.Tensor], prefix: str, lin) -> None:
    if lin is None:
        return
    if type(lin) in _MIXED:
        _put_linear(out, f"{prefix}.{_MIXED[type(lin)]}", lin.base)
        _put_linear(out, f"{prefix}.mix8", lin.int8)
        _put(out, f"{prefix}.mix_cols", lin.col_idx.to(torch.int32))
        _put(out, f"{prefix}.bias", lin.bias)
        return
    keys = _KEYS.get(type(lin))
    if keys is None:
        raise ValueError(
            f"{prefix}: cannot export {type(lin).__name__}; use "
            "runtime_format int8/int4/bf16"
        )
    for attr, key in keys:
        _put(out, f"{prefix}.{key}", getattr(lin, attr))
    _put(out, f"{prefix}.bias", lin.bias)


def _flatten_block(out: Dict[str, torch.Tensor], p: str, block: Block):
    """One decoder block's runtime tensors under ``p`` (``blocks.{i}``)."""

    def put_mlp(prefix, mlp):
        for name in _MLP:
            _put_linear(out, f"{prefix}.{name}", getattr(mlp, name))

    _put(out, f"{p}.input_layernorm", block.input_layernorm)
    _put(out, f"{p}.post_attention_layernorm", block.post_attention_layernorm)
    attn = block.attn
    if isinstance(attn, MlaAttention):
        for name in _MLA:
            _put_linear(out, f"{p}.attn.{name}", getattr(attn, name))
        for name in _MLA_ARRAYS:
            _put(out, f"{p}.attn.{name}", getattr(attn, name))
    else:
        for name in _ATTN:
            _put_linear(out, f"{p}.attn.{name}", getattr(attn, name))
    mlp = block.mlp
    if not isinstance(mlp, (MoeMlp, DeepseekMoe)):
        put_mlp(f"{p}.mlp", mlp)
        return out
    if isinstance(mlp, MoeMlp):
        _put_linear(out, f"{p}.mlp.router", mlp.router)
    else:
        _put(out, f"{p}.mlp.router_weight", mlp.router_weight)
        _put(out, f"{p}.mlp.correction_bias", mlp.correction_bias)
    st = mlp.stacked
    if st is not None and not len(mlp.experts):
        # the experts exist once, stacked; the format rides the key
        for name in _STACKED:
            _put(out, f"{p}.mlp.stacked_{st.fmt}.{name}", getattr(st, name))
    for e, ex in enumerate(mlp.experts):
        put_mlp(f"{p}.mlp.experts.{e}", ex)
    if isinstance(mlp, DeepseekMoe):
        put_mlp(f"{p}.mlp.shared_experts", mlp.shared_experts)
    return out


def _flatten_model(model: Model) -> Dict[str, torch.Tensor]:
    """The runtime tensors of ``model`` by their JAX names, as contiguous
    CPU tensors (a strided view would be written scrambled)."""
    out: Dict[str, torch.Tensor] = {}
    _put(out, "embed_tokens", model.embed_tokens)
    _put(out, "norm", model.norm)
    _put_linear(out, "lm_head", model.lm_head)
    for i, block in enumerate(model.blocks):
        _flatten_block(out, f"blocks.{i}", block)
    return out


def _refuse_blocked(model: Model) -> None:
    """Refuse a model that carries a blocked (``shards`` > 1) layer."""
    for name, m in model.named_modules():
        shards = getattr(m, "shards", 1)
        if shards > 1:
            raise ValueError(
                f"{name}: a blocked encoding over {shards} shards is a "
                "placement artifact of tensor parallelism (its columns "
                "padded shard by shard, a mixed layer's ids shard-local), "
                "not a one-device layer; a runtime file holds one-device "
                "layers only (calibrate with tp_shards=1 to write one)"
            )


def export_runtime(model: Model, out_dir) -> Path:
    """Write ``model``'s runtime tensors and config to ``out_dir``; a model
    with a blocked layer is refused."""
    _refuse_blocked(model)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tensors = _flatten_model(model)
    bf16_keys = []
    for k, t in tensors.items():
        if t.dtype == torch.bfloat16:
            tensors[k] = t.view(torch.uint16)
            bf16_keys.append(k)
    write_safetensors(tensors, out / "runtime.safetensors")
    meta = {
        "format_version": _FORMAT_VERSION,
        "model_config": model.cfg.to_dict(),
        "bf16_keys": bf16_keys,
    }
    with open(out / "runtime_config.json", "w") as f:
        json.dump(meta, f, indent=2)
    return out


def _check_one_device(prefix: str, in_p: int, pad_to: int, in_f: int):
    """Refuse a plane whose padded width is not a one-device encoder's for
    ``in_f`` logical columns."""
    if in_p != in_f + (-in_f) % pad_to:
        raise NotImplementedError(
            f"{prefix}: padded width {in_p} is not the one-device width of "
            f"{in_f} columns (a multiple of {pad_to}): a blocked (shards > "
            "1) encoding, a placement artifact that the file marks nowhere "
            "and a one-device reader cannot place"
        )


class _Reader:
    """Layers and blocks built from a runtime file's tensors (``raw``, CPU
    views), each copied to ``device`` as it lies; ``used`` names the
    tensors taken.

    ``shards > 1``: the tensors are a calibration's own blocks in the
    blocked layout of that many shards (a resumed calibration's, or a
    block handed from rank to rank), not a file's: the row-parallel
    layers (``o_proj``, a dense or shared ``down_proj``) are taken
    blocked and tagged so, unchecked."""

    def __init__(self, raw: Dict[str, torch.Tensor], cfg: ModelConfig,
                 device, shards: int = 1):
        self.raw, self.cfg, self.device = raw, cfg, device
        self.shards = shards
        self.used = set()
        h = cfg.hidden_size
        # the logical in_features of each projection
        self.widths = dict(
            q_proj=h, k_proj=h, v_proj=h, qkv_proj=h, kv_a_proj=h,
            q_a_proj=h, q_b_proj=cfg.q_lora_rank,
            o_proj=cfg.num_attention_heads * (
                cfg.v_head_dim if cfg.is_mla else cfg.head_dim),
            gate_proj=h, up_proj=h, gate_up_proj=h,
            down_proj=cfg.intermediate_size,
        )

    def take(self, name) -> Optional[torch.Tensor]:
        t = self.raw.get(name)
        if t is None:
            return None
        self.used.add(name)
        return t.to(self.device)

    def is_linear(self, prefix) -> bool:
        return any(f"{prefix}.{keys[0][1]}" in self.raw
                   for keys in _KEYS.values()
                   ) or f"{prefix}.mix_cols" in self.raw

    def linear(self, prefix, in_f: Optional[int], row: bool = False):
        """The layer under ``prefix``, or None; ``in_f``: its logical
        in_features (None: a mixed layer's side, whose width is its
        columns'); ``row``: a row-parallel layer, blocked when
        ``shards > 1``."""
        raw = self.raw
        blocked = row and self.shards > 1
        if f"{prefix}.mix_cols" in raw:
            cols = raw[f"{prefix}.mix_cols"]
            if not blocked and cols.numel() and not (
                bool(torch.all(cols[1:] > cols[:-1]))
                and 0 <= int(cols[0]) and int(cols[-1]) < in_f
            ):
                raise NotImplementedError(
                    f"{prefix}: mixed columns not strictly increasing inside "
                    f"{in_f}: a blocked (shards > 1) instance's shard-local "
                    "ids, which the file marks nowhere"
                )
            kind = (Int2MixedLinear if f"{prefix}.mix2.wq2p" in raw
                    else Int3MixedLinear)
            layer = kind(
                self.linear(f"{prefix}.{_MIXED[kind]}", in_f, row),
                self.linear(f"{prefix}.mix8", None),
                self.take(f"{prefix}.mix_cols"),
                self.take(f"{prefix}.bias"),
            )
        else:
            layer = None
            for kind, keys in _KEYS.items():
                if f"{prefix}.{keys[0][1]}" not in raw:
                    continue
                layer = kind(*(self.take(f"{prefix}.{key}")
                               for _, key in keys),
                             bias=self.take(f"{prefix}.bias"))
                if not blocked and in_f is not None and (
                        kind is not DenseLinear):
                    _check_one_device(
                        prefix, layer.in_padded,
                        layer.group if kind is Int8Linear else _PAD_TO[kind],
                        in_f,
                    )
                break
        if blocked and layer is not None:
            _blocked(layer, self.shards)
        return layer

    def mlp(self, prefix, down=None, row: bool = True) -> Mlp:
        """``row``: its down_proj is row-parallel (not a routed
        expert's)."""
        down = self.cfg.intermediate_size if down is None else down
        return Mlp(**{n: self.linear(f"{prefix}.{n}",
                                     down if n == "down_proj"
                                     else self.widths[n],
                                     row and n == "down_proj")
                      for n in _MLP})

    def stacked(self, prefix, down) -> Optional[StackedExperts]:
        for fmt, (kind, per_byte) in dict(
            int8=(Int8Linear, 1), int4=(Int4Linear, 2)
        ).items():
            p = f"{prefix}.stacked_{fmt}"
            if f"{p}.gate_up_wq" not in self.raw:
                continue
            st = StackedExperts(
                *(self.take(f"{p}.{name}") for name in _STACKED), fmt=fmt)
            for name, in_f in (("gate_up", self.cfg.hidden_size),
                               ("down", down)):
                wq = getattr(st, f"{name}_wq")
                in_p = wq.shape[2] * per_byte
                group = in_p // getattr(st, f"{name}_scales").shape[1]
                _check_one_device(
                    f"{p}.{name}", in_p,
                    group if kind is Int8Linear else _PAD_TO[kind], in_f,
                )
            return st
        return None

    def experts(self, prefix, down) -> list:
        n = 0
        while any(self.is_linear(f"{prefix}.experts.{n}.{m}") for m in _MLP):
            n += 1
        return [self.mlp(f"{prefix}.experts.{e}", down, row=False)
                for e in range(n)]

    def block_mlp(self, p):
        cfg = self.cfg
        if self.is_linear(f"{p}.router"):
            inter = cfg.intermediate_size
            return MoeMlp(
                router=self.linear(f"{p}.router", cfg.hidden_size),
                experts=self.experts(p, inter),
                num_experts_per_tok=cfg.num_experts_per_tok,
                stacked=self.stacked(p, inter),
            )
        if f"{p}.router_weight" not in self.raw:
            return self.mlp(p)
        mi = cfg.moe_intermediate_size
        return DeepseekMoe(
            router_weight=self.take(f"{p}.router_weight"),
            correction_bias=self.take(f"{p}.correction_bias"),
            experts=self.experts(p, mi),
            shared_experts=self.mlp(f"{p}.shared_experts",
                                    mi * cfg.n_shared_experts),
            top_k=cfg.num_experts_per_tok,
            n_group=cfg.n_group,
            topk_group=cfg.topk_group,
            norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor,
            stacked=self.stacked(p, mi),
        )

    def attention(self, p):
        if f"{p}.kv_a_norm" in self.raw:
            return MlaAttention(
                **{n: self.linear(f"{p}.{n}", self.widths[n], n == "o_proj")
                   for n in _MLA},
                **{n: self.take(f"{p}.{n}") for n in _MLA_ARRAYS},
            )
        return Attention(**{n: self.linear(f"{p}.{n}", self.widths[n],
                                           n == "o_proj")
                            for n in _ATTN})

    def block(self, p: str) -> Block:
        """The decoder block written under ``p`` (``blocks.{i}``)."""
        return Block(
            input_layernorm=self.take(f"{p}.input_layernorm"),
            attn=self.attention(f"{p}.attn"),
            post_attention_layernorm=self.take(
                f"{p}.post_attention_layernorm"),
            mlp=self.block_mlp(f"{p}.mlp"),
        )


def load_runtime_model(runtime_dir, device=None) -> Model:
    """Read a model written by :func:`export_runtime` (or by the JAX
    package's), on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    root = Path(runtime_dir)
    with open(root / "runtime_config.json") as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"runtime format {meta.get('format_version')} unsupported "
            f"(this reader takes {_FORMAT_VERSION})"
        )
    cfg = ModelConfig.from_dict(meta["model_config"])
    _check_supported(cfg)
    raw = _read_safetensors(root / "runtime.safetensors")
    for k in meta["bf16_keys"]:
        raw[k] = raw[k].view(torch.bfloat16)
    reader = _Reader(raw, cfg, device)
    blocks = [reader.block(f"blocks.{i}")
              for i in range(cfg.num_hidden_layers)]
    model = Model(
        embed_tokens=reader.take("embed_tokens"), blocks=blocks,
        norm=reader.take("norm"),
        lm_head=reader.linear("lm_head", cfg.hidden_size), cfg=cfg,
    )
    unused = sorted(set(raw) - reader.used)
    if unused:
        raise ValueError(f"tensors of no known layer: {unused[:4]}")
    return model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-m", "--model", required=True,
                   help="a local VPTQ checkpoint directory")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--runtime-format", default="int8",
                   choices=("int8", "int4", "bf16"))
    p.add_argument("--device", default="cuda",
                   help="where the layers are re-encoded (cuda or cpu)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        raise SystemExit(
            f"{sys.argv[0]}: no CUDA device is available; pass --device cpu "
            "to re-encode on the CPU"
        )
    model = load_model(
        args.model, dtype=torch.bfloat16,
        runtime_format=args.runtime_format, device=args.device,
    )
    out = export_runtime(model, args.output)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
