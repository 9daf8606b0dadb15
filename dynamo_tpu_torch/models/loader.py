"""Checkpoint loading: HF safetensors snapshots (all five families) and
llama.cpp ``.gguf`` files (the Llama family) into the port's param tree.

The port of ``dynamo_tpu/models/loader.py``. The leaves are the reference
loader's, bit for bit: the same names and layouts (``[L, in, out]`` stacks,
``[L, E, in, out]`` expert stacks, DeepSeek's split and de-interleaved MLA
projections, GPT-OSS's dequantized MXFP4 experts), every leaf cast to the
compute dtype, fp8 weights dequantized in f32 and rounded to bf16 first, as
the reference does.

The reader is the port's own, on the standard library: a shard's 8-byte
header length, its JSON header, then each tensor's ``data_offsets`` into a
private ``mmap`` of the shard, viewed with ``torch.frombuffer`` (no copy of
the shard). The loading is the port's own too: each tensor goes from its
view to the device as it is read, is transformed there (transpose, split,
permutation, dequantization) and lands in its final leaf; a stacked leaf is
allocated once on the device and filled a layer (or expert) at a time, and
with ``quantization="int8"`` each slice is quantized as it lands
(``quant.quantize_int8``), so a model too large for the card in bf16
(Mixtral-8x7B) never exists in bf16 there. The host maps one shard at a
time (its pages dropped as their tensors go, the mapping when the shard
is done) and holds one tensor's conversion; GGUF blocks dequantize on the host in numpy
(``llm/gguf_tensors.py``), as the reference does.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..engine.config import ModelConfig
from .quant import QUANT_KEYS, QuantizedWeight, quantize_int8

logger = logging.getLogger(__name__)


class SafetensorsError(ValueError):
    """A shard that is not a well-formed safetensors file (named in the
    message)."""


# safetensors dtype names → torch dtypes (the ones real checkpoints ship)
ST_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F8_E4M3": torch.float8_e4m3fn, "I8": torch.int8, "U8": torch.uint8,
    "I32": torch.int32, "I64": torch.int64,
}
_SCALE_SUFFIXES = ("_scale", "_scale_inv")
_SKIPPED_SCALES = ("input_scale", "k_scale", "v_scale")
# a header larger than this is not a safetensors header
_MAX_HEADER = 100 << 20


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """One shard's tensor table ({name: {"dtype", "shape", "data_offsets"}})
    and the file offset its data starts at; raises ``SafetensorsError``
    naming the file when it is empty, truncated or malformed."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(
                f"{path}: not a safetensors file ({size} bytes, no header "
                "length)")
        n = struct.unpack("<Q", raw)[0]
        if n > min(size - 8, _MAX_HEADER):
            raise SafetensorsError(
                f"{path}: header length {n} runs past the file's {size} bytes")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SafetensorsError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    data = size - 8 - n
    for name, info in header.items():
        try:
            dtype = ST_DTYPES[info["dtype"]]
            a, b = (int(x) for x in info["data_offsets"])
            numel = math.prod(int(d) for d in info["shape"])
        except KeyError as e:
            raise SafetensorsError(
                f"{path}: tensor {name!r} has an unsupported dtype or no "
                f"{e} entry") from None
        except (TypeError, ValueError):
            raise SafetensorsError(
                f"{path}: tensor {name!r} has a malformed entry {info}") from None
        if not (0 <= a <= b <= data) or b - a != numel * dtype.itemsize:
            raise SafetensorsError(
                f"{path}: tensor {name!r} data [{a}, {b}) does not fit the "
                f"file's {data} data bytes or its shape {info['shape']}")
    return header, 8 + n


class _Shard:
    """One shard: its header, and while it is walked (``open`` to
    ``close``) a private mapping of it. ``tensor`` views a tensor's bytes
    in the mapping without a copy (outside a walk it reads them: an fp8
    scale in another shard); ``release`` drops a tensor's pages once it has
    gone, and ``close`` the mapping, unmapped with the last view of it."""

    def __init__(self, path: str):
        self.path = path
        self.header, self.start = read_header(path)
        self.mm = None

    def open(self) -> None:
        with open(self.path, "rb") as f:
            # ACCESS_COPY: a private, writable mapping (torch.frombuffer
            # wants one); nothing is ever written, so no page is copied
            if os.fstat(f.fileno()).st_size:
                self.mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)

    def close(self) -> None:
        self.mm = None

    def tensor(self, name: str) -> torch.Tensor:
        info = self.header[name]
        dtype = ST_DTYPES[info["dtype"]]
        a, b = info["data_offsets"]
        shape = [int(d) for d in info["shape"]]
        if b == a:
            return torch.empty(shape, dtype=dtype)
        if self.mm is None:
            with open(self.path, "rb") as f:
                f.seek(self.start + a)
                raw = torch.frombuffer(bytearray(f.read(b - a)),
                                       dtype=torch.uint8)
        else:
            raw = torch.frombuffer(self.mm, dtype=torch.uint8, count=b - a,
                                   offset=self.start + a)
        return raw.view(dtype).reshape(shape)

    def release(self, name: str) -> None:
        a, b = self.header[name]["data_offsets"]
        page = mmap.PAGESIZE
        lo = (self.start + a) // page * page
        if self.mm is not None and hasattr(self.mm, "madvise") and b > a:
            self.mm.madvise(mmap.MADV_DONTNEED, lo, self.start + b - lo)


def shard_paths(model_dir: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {model_dir}")
    return files


def check_checkpoint(model_dir: str) -> None:
    """Parse every shard's header (cheap: no tensor is read), so a
    truncated or empty shard fails before a model is built."""
    for path in shard_paths(model_dir):
        read_header(path)


def _dequant_fp8(arr: torch.Tensor, scale: Optional[torch.Tensor],
                 inverse_blocks: bool) -> torch.Tensor:
    """An fp8 tensor (as f32) times its scale, in f32 (the reference's
    ``_dequant_fp8``): ``weight_scale`` per tensor or per output channel,
    or DeepSeek's ``weight_scale_inv`` per 128 x 128 block, the last block
    of each axis partial."""
    if scale is None:
        return arr
    scale = scale.to(torch.float32)
    if inverse_blocks and scale.dim() == 2 and arr.dim() == 2:
        bs_ = 128
        expanded = scale.repeat_interleave(bs_, 0).repeat_interleave(bs_, 1)
        return arr * expanded[: arr.shape[0], : arr.shape[1]]
    if scale.dim() == 1 and arr.dim() >= 2 and scale.numel() == arr.shape[0]:
        scale = scale.reshape(-1, *([1] * (arr.dim() - 1)))
    return arr * scale


def iter_safetensors(model_dir: str, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor on ``device``) for every tensor of every shard, in
    the shards' sorted order (a sharded snapshot's index file is not needed:
    every ``*.safetensors`` is read, as the reference does). The scale
    tensors are consumed with their weight: an fp8 weight comes out
    dequantized to bf16 (``_dequant_fp8`` on the device, its scale found in
    any shard)."""
    shards = [_Shard(p) for p in shard_paths(model_dir)]
    where = {name: s for s in shards for name in s.header}
    warned = False
    for shard in shards:
        shard.open()
        try:
            for name in shard.header:
                if name.endswith(_SCALE_SUFFIXES) or name.endswith(_SKIPPED_SCALES):
                    continue
                t = shard.tensor(name).to(device)
                if t.dtype == torch.float8_e4m3fn:
                    if not warned:
                        warned = True
                        logger.warning("fp8 checkpoint: weights dequantized to "
                                       "bf16 at load")
                    scale, inverse = None, False
                    for suffix in _SCALE_SUFFIXES:
                        holder = where.get(name + suffix)
                        if holder is not None:
                            scale = holder.tensor(name + suffix).to(device)
                            inverse = suffix == "_scale_inv"
                            break
                    t = _dequant_fp8(t.float(), scale, inverse).to(torch.bfloat16)
                yield name, t
                del t
                shard.release(name)
        finally:
            shard.close()


# ---------------------------------------------------------------- the tree


class _DeviceTree:
    """The param tree built on ``device`` a slice at a time: ``put`` casts a
    slice to ``dtype`` (and quantizes a ``quant_keys`` leaf's slice to
    int8) into its stacked leaf, allocated on the first slice; ``params``
    checks every leaf is complete."""

    def __init__(self, device, dtype, quant_keys, label: str):
        self.device, self.dtype = device, dtype
        self.quant_keys, self.label = quant_keys, label
        self.top: Dict[str, object] = {}
        self.groups: Dict[str, Dict[str, object]] = {}
        self.filled: Dict[Tuple[str, str], set] = {}
        self.counts: Dict[Tuple[str, str], Tuple[int, ...]] = {}

    def _alloc(self, key, shape):
        if key in self.quant_keys:
            return QuantizedWeight(
                torch.empty(shape, dtype=torch.int8, device=self.device),
                torch.empty((*shape[:-2], shape[-1]), dtype=torch.float32,
                            device=self.device))
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def _store(self, dst, key, t) -> None:
        t = t.to(device=self.device, dtype=self.dtype)
        if isinstance(dst, QuantizedWeight):
            w = quantize_int8(t)
            dst.q.copy_(w.q)
            dst.scale.copy_(w.scale)
        else:
            dst.copy_(t)

    def put_top(self, key: str, t: torch.Tensor) -> None:
        leaf = self._alloc(key, tuple(t.shape))
        self._store(leaf, key, t)
        self.top[key] = leaf

    def put(self, group: str, key: str, idx, count: Tuple[int, ...],
            t: torch.Tensor) -> None:
        """Slice ``idx`` (a layer, or a (layer, expert) pair) of the
        ``count``-stacked leaf ``group.key``."""
        idx_t = idx if isinstance(idx, tuple) else (idx,)
        name = f"{self.label}.{group}.{key}"
        if len(idx_t) != len(count) or not all(0 <= i < n for i, n in
                                               zip(idx_t, count)):
            raise ValueError(f"checkpoint tensor {name}[{idx}] lies outside "
                             f"the config's {count}")
        leaves = self.groups.setdefault(group, {})
        shape = (*count, *t.shape)
        leaf = leaves.get(key)
        if leaf is None:
            leaf = leaves[key] = self._alloc(key, shape)
            self.counts[(group, key)] = count
            self.filled[(group, key)] = set()
        elif tuple(leaf.shape) != shape:
            raise ValueError(f"checkpoint tensor {name}[{idx}] has shape "
                             f"{tuple(t.shape)}, the others {tuple(leaf.shape)[len(count):]}")
        self._store(leaf[idx_t], key, t)
        self.filled[(group, key)].add(idx_t)

    def missing(self, group: str, keys) -> List[str]:
        return sorted(k for k in keys if k not in self.groups.get(group, {}))

    def params(self, required_top=("embed", "final_norm")) -> Dict:
        for (group, key), got in self.filled.items():
            want = math.prod(self.counts[(group, key)])
            if len(got) != want:
                raise ValueError(
                    f"incomplete checkpoint: {self.label}.{group}.{key} has "
                    f"{len(got)}/{want} tensors")
        absent = [k for k in required_top if k not in self.top]
        if absent:
            raise ValueError(f"incomplete checkpoint: {self.label} has no "
                             f"{absent}")
        out = dict(self.top)
        out.update(self.groups)
        return out


def _quant_keys(cfg: ModelConfig):
    return QUANT_KEYS if cfg.quantization else frozenset()


def _route_top(tree: _DeviceTree, name: str, t: torch.Tensor) -> bool:
    """embed / final norm / lm_head (transposed to [D, V])."""
    if name == "embed_tokens.weight":
        tree.put_top("embed", t)
    elif name == "norm.weight":
        tree.put_top("final_norm", t)
    elif name == "lm_head.weight":
        tree.put_top("lm_head", t.T)
    else:
        return False
    return True


# ------------------------------------------------------------ dense trunks


_LLAMA_MAP = {
    "input_layernorm.weight": ("ln1", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("ln2", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    # Qwen2-family qkv biases: optional, then complete
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    # Qwen3-family per-head q/k norms
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
}
_GEMMA2_MAP = {
    "input_layernorm.weight": ("ln1", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("ln_post_attn", False),
    "pre_feedforward_layernorm.weight": ("ln_pre_mlp", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "post_feedforward_layernorm.weight": ("ln_post_mlp", False),
}


def _load_dense(model_dir, cfg, dtype, device, mapping, required, label):
    l = cfg.num_layers
    tree = _DeviceTree(device, dtype, _quant_keys(cfg), label)
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    for name, t in iter_safetensors(model_dir, device):
        name = name.removeprefix("model.")
        if _route_top(tree, name, t) or not name.startswith("layers."):
            continue
        _, idx, rest = name.split(".", 2)
        i = int(idx)
        if rest in mapping:
            key, transpose = mapping[rest]
            tree.put("layers", key, i, (l,), t.T if transpose else t)
        elif rest == "self_attn.qkv_proj.weight" and label == "llama":
            # Phi-3's fused [q | k | v] rows
            t = t.T
            if t.shape[1] != qd + 2 * kvd:
                raise ValueError(
                    f"fused qkv width {t.shape[1]} != heads*hd + 2*kv*hd "
                    f"= {qd + 2 * kvd} (config/checkpoint mismatch)")
            for key, part in (("wq", t[:, :qd]), ("wk", t[:, qd:qd + kvd]),
                              ("wv", t[:, qd + kvd:])):
                tree.put("layers", key, i, (l,), part)
        elif rest == "mlp.gate_up_proj.weight" and label == "llama":
            t = t.T
            if t.shape[1] != 2 * inter:
                raise ValueError(f"fused gate_up width {t.shape[1]} != "
                                 f"2*intermediate_size = {2 * inter}")
            tree.put("layers", "w_gate", i, (l,), t[:, :inter])
            tree.put("layers", "w_up", i, (l,), t[:, inter:])
        else:
            logger.debug("skipping unmapped tensor %s", name)
    missing = tree.missing("layers", required)
    if missing:
        raise ValueError(f"incomplete checkpoint: {label} layers have no "
                         f"{missing}")
    params = tree.params()
    if "lm_head" not in params and not cfg.tie_word_embeddings:
        logger.info("no lm_head tensor; using tied embeddings")
    return params


def load_llama_params(model_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                      device="cpu") -> Dict:
    """HF Llama / Mistral / Qwen2 / Qwen3 / Phi-3 checkpoint → the llama
    family's tree."""
    return _load_dense(
        model_dir, cfg, dtype, device, _LLAMA_MAP,
        ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down"),
        "llama")


def load_gemma2_params(model_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                       device="cpu") -> Dict:
    """HF Gemma2ForCausalLM checkpoint → the gemma2 family's tree (an
    untied finetune's lm_head is kept when present)."""
    return _load_dense(model_dir, cfg, dtype, device, _GEMMA2_MAP,
                       tuple(k for k, _ in _GEMMA2_MAP.values()), "gemma2")


# ------------------------------------------------------------- MoE trunks


_MIXTRAL_ATTN = {
    "input_layernorm.weight": ("ln1", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "post_attention_layernorm.weight": ("ln2", False),
    "block_sparse_moe.gate.weight": ("router", True),
    "mlp.gate.weight": ("router", True),
}
_EXPERT_PROJ = {
    "w1": "w_gate", "w2": "w_down", "w3": "w_up",              # Mixtral
    "gate_proj": "w_gate", "down_proj": "w_down", "up_proj": "w_up",
}


def load_mixtral_params(model_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                        device="cpu") -> Dict:
    """HF Mixtral (``block_sparse_moe.{gate, experts.N.w1/w2/w3}``) or
    Qwen3-MoE (``mlp.{gate, experts.N.gate/up/down_proj}`` + q/k norms)
    checkpoint → the mixtral family's tree, experts stacked [L, E, in,
    out]."""
    l, e = cfg.num_layers, cfg.num_experts
    tree = _DeviceTree(device, dtype, _quant_keys(cfg), "mixtral")
    for name, t in iter_safetensors(model_dir, device):
        name = name.removeprefix("model.")
        if _route_top(tree, name, t) or not name.startswith("layers."):
            continue
        _, idx, rest = name.split(".", 2)
        i = int(idx)
        if rest in _MIXTRAL_ATTN:
            key, transpose = _MIXTRAL_ATTN[rest]
            tree.put("layers", key, i, (l,), t.T if transpose else t)
        elif rest.startswith(("block_sparse_moe.experts.", "mlp.experts.")):
            _, _, ei, proj, _ = rest.split(".")
            tree.put("layers", _EXPERT_PROJ[proj], (i, int(ei)), (l, e), t.T)
        elif rest.startswith("mlp.shared_expert"):
            raise NotImplementedError(
                "Qwen2-MoE shared-expert checkpoints are not supported "
                "(gated shared expert); Qwen3-MoE and Mixtral load")
        else:
            logger.debug("skipping unmapped tensor %s", name)
    return tree.params()


# MXFP4 (GPT-OSS's release format): e2m1 values two a byte in groups of 32
# (16 bytes), one e8m0 exponent (biased 127) a group
_FP4_VALUES = torch.tensor(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], dtype=torch.float32)


def _dequant_mxfp4(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[..., G, 16] uint8 blocks + [..., G] uint8 exponents → [..., G * 32]
    f32, the low nibble first (the reference's ``_dequant_mxfp4``)."""
    lut = _FP4_VALUES.to(blocks.device)
    b = blocks.long()
    vals = torch.stack([lut[b & 0x0F], lut[b >> 4]], dim=-1)
    vals = vals.reshape(*blocks.shape[:-1], 32)
    # 2^(s - 127) built from its f32 bits, exact on any device: s << 23
    # (s 255: inf), and s 0 the subnormal 2^-127
    e = scales.to(torch.int32)
    scale = torch.where(e == 0, 1 << 22, e << 23).view(torch.float32)
    vals *= scale[..., None]
    return vals.reshape(*blocks.shape[:-2], blocks.shape[-2] * 32)


_GPTOSS_MAP = {
    "input_layernorm.weight": ("ln1", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.o_proj.bias": ("bo", False),
    "self_attn.sinks": ("sinks", False),
    "post_attention_layernorm.weight": ("ln2", False),
    "mlp.router.weight": ("router", True),
    "mlp.router.bias": ("router_bias", False),
    "mlp.experts.gate_up_proj": ("w_gate_up", False),
    "mlp.experts.gate_up_proj_bias": ("b_gate_up", False),
    "mlp.experts.down_proj": ("w_down", False),
    "mlp.experts.down_proj_bias": ("b_down", False),
}


def load_gptoss_params(model_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                       device="cpu") -> Dict:
    """HF GPT-OSS checkpoint → the gptoss family's tree. The expert
    projections arrive stacked a layer ([E, D, 2I] / [E, I, D]) and load as
    they are; MXFP4 releases (``*_blocks`` + ``*_scales``, [E, out, in])
    dequantize on the device once both halves of a layer are read, and
    transpose into the [E, in, out] stacks."""
    l = cfg.num_layers
    tree = _DeviceTree(device, dtype, _quant_keys(cfg), "gptoss")
    pending: Dict[Tuple[str, int], Dict[str, torch.Tensor]] = {}
    for name, t in iter_safetensors(model_dir, device):
        name = name.removeprefix("model.")
        if _route_top(tree, name, t) or not name.startswith("layers."):
            continue
        _, idx, rest = name.split(".", 2)
        i = int(idx)
        if rest in _GPTOSS_MAP:
            key, transpose = _GPTOSS_MAP[rest]
            tree.put("layers", key, i, (l,), t.T if transpose else t)
        elif rest.startswith("mlp.experts.") and rest.endswith(("_blocks",
                                                                "_scales")):
            proj, kind = rest.removeprefix("mlp.experts.").rsplit("_", 1)
            key = {"gate_up_proj": "w_gate_up", "down_proj": "w_down"}[proj]
            halves = pending.setdefault((key, i), {})
            halves[kind] = t
            if len(halves) == 2:
                del pending[(key, i)]
                w = _dequant_mxfp4(halves["blocks"], halves["scales"])
                tree.put("layers", key, i, (l,), w.transpose(1, 2))
        else:
            logger.debug("skipping unmapped tensor %s", name)
    for (key, i), halves in pending.items():
        if "blocks" in halves:
            raise ValueError(f"incomplete MXFP4 checkpoint: layers.{key} "
                             f"layer {i} has blocks but no scales")
    missing = tree.missing("layers", {k for k, _ in _GPTOSS_MAP.values()})
    if missing:
        raise ValueError(f"incomplete checkpoint: layers missing {missing} "
                         "(unrecognized tensor naming or quantization format?)")
    return tree.params()


# ------------------------------------------------------------- MLA trunk


def _rope_deinterleave(n: int) -> torch.Tensor:
    """HF DeepSeek's interleaved rope pairs (x[2j], x[2j+1]) → the
    half-rotation layout (x[j], x[j + n/2]) the port's rope uses, applied
    to both q's and k's rope columns (so their product is unchanged)."""
    return torch.cat([torch.arange(0, n, 2), torch.arange(1, n, 2)])


_DS_DENSE_MLP = {"mlp.gate_proj.weight": "w_gate", "mlp.up_proj.weight": "w_up",
                 "mlp.down_proj.weight": "w_down"}
_DS_PROJ = {"gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}
_DS_SHARED = {"gate_proj": "w_sh_gate", "up_proj": "w_sh_up",
              "down_proj": "w_sh_down"}


def load_deepseek_params(model_dir: str, cfg: ModelConfig, dtype=torch.bfloat16,
                         device="cpu") -> Dict:
    """HF DeepSeek-V2 / V3 checkpoint → the deepseek family's tree:
    ``kv_a_proj_with_mqa`` splits into ``w_dkv`` and the shared rope key
    projection ``w_kr``, ``kv_b_proj`` into the absorbed ``w_uk`` / ``w_uv``
    [r, H, *], the rope columns of q and ``w_kr`` are de-interleaved, the
    first ``first_k_dense_replace`` layers form ``dense_layers`` and the MoE
    tail ``layers`` (restacked from 0); V3's ``e_score_correction_bias`` is
    ``router_bias``."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, h, vd = cfg.kv_lora_rank, cfg.num_heads, cfg.v_head_dim
    n_dense = (min(cfg.first_k_dense_replace, cfg.num_layers)
               if cfg.num_experts else cfg.num_layers)
    n_moe = cfg.num_layers - n_dense
    e = cfg.num_experts
    perm = _rope_deinterleave(rope).to(device)
    tree = _DeviceTree(device, dtype, _quant_keys(cfg), "deepseek")

    def q_deinterleave(t):  # [in, H * (nope + rope)]
        t = t.reshape(t.shape[0], h, nope + rope)
        t = torch.cat([t[..., :nope], t[..., nope + perm]], dim=-1)
        return t.reshape(t.shape[0], -1)

    for name, t in iter_safetensors(model_dir, device):
        name = name.removeprefix("model.")
        if _route_top(tree, name, t) or not name.startswith("layers."):
            continue
        _, idx, rest = name.split(".", 2)
        idx = int(idx)
        group, n, li = (("dense_layers", n_dense, idx) if idx < n_dense
                        else ("layers", n_moe, idx - n_dense))

        def put(key, value, sub=None):
            if sub is None:
                tree.put(group, key, li, (n,), value)
            else:
                tree.put(group, key, (li, sub), (n, e), value)

        if rest == "input_layernorm.weight":
            put("ln1", t)
        elif rest == "post_attention_layernorm.weight":
            put("ln2", t)
        elif rest == "self_attn.q_proj.weight":
            put("wq", q_deinterleave(t.T))
        elif rest == "self_attn.q_a_proj.weight":
            put("w_dq", t.T)
        elif rest == "self_attn.q_a_layernorm.weight":
            put("ln_q", t)
        elif rest == "self_attn.q_b_proj.weight":
            put("w_uq", q_deinterleave(t.T))
        elif rest == "self_attn.kv_a_proj_with_mqa.weight":
            t = t.T  # [D, r + rope]
            put("w_dkv", t[:, :r])
            put("w_kr", t[:, r:][:, perm])
        elif rest == "self_attn.kv_a_layernorm.weight":
            put("ln_kv", t)
        elif rest == "self_attn.kv_b_proj.weight":
            t = t.reshape(h, nope + vd, r)
            put("w_uk", t[:, :nope, :].permute(2, 0, 1))
            put("w_uv", t[:, nope:, :].permute(2, 0, 1))
        elif rest == "self_attn.o_proj.weight":
            put("wo", t.T)
        elif rest.startswith("mlp.experts."):
            _, _, ei, proj, _ = rest.split(".")
            put(_DS_PROJ[proj], t.T, int(ei))
        elif rest.startswith("mlp.shared_experts."):
            put(_DS_SHARED[rest.split(".")[2]], t.T)
        elif rest == "mlp.gate.weight":
            put("router", t.T)
        elif rest == "mlp.gate.e_score_correction_bias":
            put("router_bias", t)
        elif rest in _DS_DENSE_MLP:
            put(_DS_DENSE_MLP[rest], t.T)
        else:
            logger.debug("skipping unmapped tensor %s", name)
    return tree.params()


# ------------------------------------------------------------------- GGUF


def _gguf_unpermute(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """Undo llama.cpp's q/k row permutation on an [out, in] weight (its
    converter interleaves each head's rope halves for ggml's rope; the port
    rotates halves, as HF does)."""
    out, inner = w.shape
    hd = out // n_head
    return (w.reshape(n_head, hd // 2, 2, inner).transpose(1, 2)
            .reshape(out, inner))


_GGUF_MAP = {
    "attn_norm.weight": ("ln1", False),
    "attn_q.weight": ("wq", True),
    "attn_k.weight": ("wk", True),
    "attn_v.weight": ("wv", True),
    "attn_output.weight": ("wo", True),
    "ffn_norm.weight": ("ln2", False),
    "ffn_gate.weight": ("w_gate", True),
    "ffn_up.weight": ("w_up", True),
    "ffn_down.weight": ("w_down", True),
}


def load_gguf_llama_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16,
                           device="cpu") -> Dict:
    """llama.cpp ``.gguf`` file → the llama family's tree: each tensor
    dequantized on the host to f32 (``llm/gguf_tensors.py``), narrowed to
    the compute dtype and sent to its leaf (``blk.N.attn_q`` … names; q and
    k unpermuted)."""
    from ..llm.gguf import read_gguf
    from ..llm.gguf_tensors import iter_gguf_tensors

    l = cfg.num_layers
    tree = _DeviceTree(device, dtype, _quant_keys(cfg), "gguf")
    for name, arr in iter_gguf_tensors(path, read_gguf(path)):
        t = torch.from_numpy(arr).to(device=device, dtype=dtype)
        del arr
        if name == "token_embd.weight":
            tree.put_top("embed", t)
        elif name == "output_norm.weight":
            tree.put_top("final_norm", t)
        elif name == "output.weight":
            tree.put_top("lm_head", t.T)
        elif name.startswith("blk."):
            _, idx, rest = name.split(".", 2)
            if rest not in _GGUF_MAP:
                logger.debug("skipping unmapped gguf tensor %s", name)
                continue
            key, transpose = _GGUF_MAP[rest]
            if key == "wq":
                t = _gguf_unpermute(t, cfg.num_heads)
            elif key == "wk":
                t = _gguf_unpermute(t, cfg.num_kv_heads)
            tree.put("layers", key, int(idx), (l,), t.T if transpose else t)
    missing = tree.missing("layers", {k for k, _ in _GGUF_MAP.values()})
    if missing:
        raise ValueError(f"incomplete gguf checkpoint: layers have no {missing}")
    params = tree.params()
    if "lm_head" not in params and not cfg.tie_word_embeddings:
        logger.info("no output.weight in gguf; using tied embeddings")
    return params


# --------------------------------------------------------------- dispatch


_LOADERS = {
    "llama": load_llama_params,
    "mixtral": load_mixtral_params,
    "deepseek": load_deepseek_params,
    "gemma2": load_gemma2_params,
    "gptoss": load_gptoss_params,
}


def load_checkpoint_params(model_dir: str, cfg: ModelConfig, arch,
                           dtype=torch.bfloat16, device="cpu") -> Dict:
    """The loader of the resolved family module ``arch`` for an HF snapshot
    directory or a ``.gguf`` file, on ``device``; with
    ``cfg.quantization`` the ``QUANT_KEYS`` leaves come back int8. An
    architecture without a loader raises: a checkpoint never turns into
    random weights."""
    name = arch.__name__.rsplit(".", 1)[-1]
    if model_dir.endswith(".gguf"):
        if name != "llama":
            raise NotImplementedError(
                f"gguf loading is llama-family only (got {name!r})")
        return load_gguf_llama_params(model_dir, cfg, dtype, device)
    if name not in _LOADERS:
        raise NotImplementedError(
            f"no weight loader for architecture {name!r} (checkpoint at "
            f"{model_dir})")
    params = _LOADERS[name](model_dir, cfg, dtype, device)
    if name in ("mixtral", "deepseek"):
        # their trees have no optional keys: every key the family reads
        missing = sorted(f"{group}.{k}" for group, keys in
                         arch.param_keys(cfg).items()
                         for k in keys - set(params.get(group, {})))
        if missing:
            raise ValueError(f"incomplete checkpoint: {name} has no {missing}")
    return params


def has_checkpoint(model_dir: str) -> bool:
    if model_dir.endswith(".gguf"):
        return os.path.exists(model_dir)
    return bool(glob.glob(os.path.join(model_dir, "*.safetensors")))


def resolve_weights(model_dir: str, allow_random: bool) -> bool:
    """The reference runner's weight rule for a model directory (or a
    ``.gguf`` file): True when it holds a checkpoint, whose shards' headers
    are parsed here (an empty or truncated shard raises naming its file; a
    ``.gguf``'s header is parsed by its model card's reader); without one,
    False (seeded random weights) only with ``allow_random``, else
    ``FileNotFoundError``."""
    if has_checkpoint(model_dir):
        if not model_dir.endswith(".gguf"):
            check_checkpoint(model_dir)
        return True
    if not allow_random:
        raise FileNotFoundError(
            f"no *.safetensors under {model_dir}; the engine will not "
            "silently serve random weights — provide a safetensors "
            "checkpoint or set allow_random_weights (--allow-random-weights)")
    logger.warning("no checkpoint in %s — random init", model_dir)
    return False
