"""GGUF metadata reader: model cards, architecture configs and tokenizers
from ``.gguf`` files.

The port of ``dynamo_tpu/llm/gguf.py``: a pure-Python parser of the GGUF
container (v2 / v3) — header, metadata key/values and tensor descriptors
(``llm/gguf_tensors.py`` reads the tensor data) — enough to build a
``ModelDeploymentCard``, a ``ModelConfig`` and the port's tokenizer from a
GGUF checkpoint (reference: lib/llm/src/gguf/*, and
``ModelDeploymentCard::from_gguf`` in lib/llm/src/model_card/create.rs).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO, Dict, List, Optional, Tuple

GGUF_MAGIC = b"GGUF"

# metadata value types (gguf spec)
_T_UINT8, _T_INT8, _T_UINT16, _T_INT16 = 0, 1, 2, 3
_T_UINT32, _T_INT32, _T_FLOAT32, _T_BOOL = 4, 5, 6, 7
_T_STRING, _T_ARRAY, _T_UINT64, _T_INT64, _T_FLOAT64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    _T_UINT8: "<B", _T_INT8: "<b", _T_UINT16: "<H", _T_INT16: "<h",
    _T_UINT32: "<I", _T_INT32: "<i", _T_FLOAT32: "<f",
    _T_UINT64: "<Q", _T_INT64: "<q", _T_FLOAT64: "<d",
}

# tensor ggml dtypes we can name (id → name); quantized types included so
# descriptors are informative even when we never load the data
GGML_TYPE_NAMES = {
    0: "f32", 1: "f16", 2: "q4_0", 3: "q4_1", 6: "q5_0", 7: "q5_1",
    8: "q8_0", 9: "q8_1", 10: "q2_k", 11: "q3_k", 12: "q4_k", 13: "q5_k",
    14: "q6_k", 15: "q8_k", 16: "iq2_xxs", 17: "iq2_xs", 18: "iq3_xxs",
    24: "i8", 25: "i16", 26: "i32", 27: "i64", 28: "f64", 30: "bf16",
}


class GgufError(ValueError):
    pass


@dataclasses.dataclass
class GgufTensorInfo:
    name: str
    shape: Tuple[int, ...]
    ggml_type: int
    offset: int

    @property
    def type_name(self) -> str:
        return GGML_TYPE_NAMES.get(self.ggml_type, f"unknown({self.ggml_type})")


@dataclasses.dataclass
class GgufFile:
    version: int
    metadata: Dict[str, Any]
    tensors: List[GgufTensorInfo]
    data_offset: int = 0  # absolute file offset where tensor data begins

    @property
    def architecture(self) -> Optional[str]:
        return self.metadata.get("general.architecture")

    def arch_key(self, suffix: str, default=None):
        """Lookup '{arch}.{suffix}' (e.g. llama.context_length)."""
        arch = self.architecture
        if arch is None:
            return default
        return self.metadata.get(f"{arch}.{suffix}", default)


def _read(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise GgufError("truncated GGUF file")
    return struct.unpack(fmt, data)[0]


def _read_string(f: BinaryIO) -> str:
    n = _read(f, "<Q")
    data = f.read(n)
    if len(data) != n:
        raise GgufError("truncated GGUF string")
    return data.decode("utf-8", errors="replace")


def _remaining(f: BinaryIO) -> int:
    import os

    return os.fstat(f.fileno()).st_size - f.tell()


def _read_value(f: BinaryIO, vtype: int, depth: int = 0) -> Any:
    if vtype in _SCALAR_FMT:
        return _read(f, _SCALAR_FMT[vtype])
    if vtype == _T_BOOL:
        return bool(_read(f, "<B"))
    if vtype == _T_STRING:
        return _read_string(f)
    if vtype == _T_ARRAY:
        if depth > 4:
            raise GgufError("GGUF array nesting too deep")
        item_type = _read(f, "<I")
        count = _read(f, "<Q")
        # every element consumes >= 1 byte: a count beyond the remaining
        # file size is corrupt and would otherwise exhaust memory before
        # the truncation error fires
        if count > _remaining(f):
            raise GgufError(f"implausible GGUF array count {count}")
        return [_read_value(f, item_type, depth + 1) for _ in range(count)]
    raise GgufError(f"unknown GGUF metadata type {vtype}")


def read_gguf(path: str, max_tensors: int = 100_000) -> GgufFile:
    """Parse header + metadata + tensor descriptors (no tensor data)."""
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise GgufError(f"{path} is not a GGUF file")
        version = _read(f, "<I")
        if version not in (2, 3):
            raise GgufError(f"unsupported GGUF version {version} (need 2 or 3)")
        tensor_count = _read(f, "<Q")
        kv_count = _read(f, "<Q")
        if tensor_count > max_tensors:
            raise GgufError(f"implausible tensor count {tensor_count}")
        if kv_count > _remaining(f):
            raise GgufError(f"implausible metadata count {kv_count}")

        metadata: Dict[str, Any] = {}
        for _ in range(kv_count):
            key = _read_string(f)
            vtype = _read(f, "<I")
            metadata[key] = _read_value(f, vtype)

        tensors: List[GgufTensorInfo] = []
        for _ in range(tensor_count):
            name = _read_string(f)
            n_dims = _read(f, "<I")
            if n_dims > 8:
                raise GgufError(f"implausible tensor rank {n_dims}")
            shape = tuple(_read(f, "<Q") for _ in range(n_dims))
            ggml_type = _read(f, "<I")
            offset = _read(f, "<Q")
            tensors.append(GgufTensorInfo(name, shape, ggml_type, offset))
        # tensor data begins at the next alignment boundary; per-tensor
        # offsets (above) are relative to this point
        align = int(metadata.get("general.alignment", 32) or 32)
        data_offset = (f.tell() + align - 1) // align * align
    return GgufFile(
        version=version, metadata=metadata, tensors=tensors,
        data_offset=data_offset,
    )


def hf_config_from_gguf(g: GgufFile) -> Dict[str, Any]:
    """GGUF architecture metadata → HF config.json-shaped dict.

    One translation shared by the MDC (whose ``config`` field rides the
    discovery plane and feeds engine_config_from_mdc) and
    model_config_from_gguf, so a .gguf-backed worker builds the same
    ModelConfig as a snapshot-backed one.

    Only architectures whose converters share the llama graph + q/k
    permute are accepted — anything else must fail HERE, loudly, or the
    llama loader would serve plausible-looking garbage for e.g. a qwen2
    export (biases dropped, unpermute applied that its converter never
    performed).
    """
    arch = g.architecture
    if arch not in ("llama", "mistral"):
        raise GgufError(
            f"unsupported GGUF architecture {arch!r} (supported: llama, "
            "mistral — other families need their own tensor mapping)"
        )
    tokens = g.metadata.get("tokenizer.ggml.tokens")
    heads = g.arch_key("attention.head_count", 32)
    tied = g.metadata.get("general.tie_word_embeddings")
    if tied is None:
        # llama.cpp omits the flag; tied models simply ship no output.weight
        tied = not any(t.name == "output.weight" for t in g.tensors)
    cfg: Dict[str, Any] = {
        "vocab_size": len(tokens) if tokens else g.arch_key("vocab_size", 32000),
        "hidden_size": g.arch_key("embedding_length", 4096),
        "intermediate_size": g.arch_key("feed_forward_length", 11008),
        "num_hidden_layers": g.arch_key("block_count", 32),
        "num_attention_heads": heads,
        "num_key_value_heads": g.arch_key("attention.head_count_kv", heads),
        "rope_theta": float(g.arch_key("rope.freq_base", 10000.0)),
        "rms_norm_eps": float(
            g.arch_key("attention.layer_norm_rms_epsilon", 1e-5)
        ),
        "max_position_embeddings": g.arch_key("context_length", 4096),
        "tie_word_embeddings": bool(tied),
        "architectures": ["LlamaForCausalLM"],
    }
    key_len = g.arch_key("attention.key_length")
    if key_len:
        cfg["head_dim"] = key_len
    scale_type = g.arch_key("rope.scaling.type")
    if scale_type and scale_type != "none":  # llama.cpp writes "none"
        cfg["rope_scaling"] = {
            "rope_type": scale_type,
            "factor": float(g.arch_key("rope.scaling.factor", 1.0) or 1.0),
            "original_max_position_embeddings": g.arch_key(
                "rope.scaling.original_context_length",
                cfg["max_position_embeddings"],
            ),
        }
    experts = g.arch_key("expert_count", 0) or 0
    if experts:
        cfg["num_local_experts"] = experts
        cfg["num_experts_per_tok"] = g.arch_key("expert_used_count", 2) or 2
        cfg["architectures"] = ["MixtralForCausalLM"]
    eos = g.metadata.get("tokenizer.ggml.eos_token_id")
    if eos is not None:
        cfg["eos_token_id"] = eos
    bos = g.metadata.get("tokenizer.ggml.bos_token_id")
    if bos is not None:
        cfg["bos_token_id"] = bos
    return cfg


def model_config_from_gguf(g: GgufFile):
    """Architecture config from GGUF metadata (llama-family keys)."""
    from ..engine.config import ModelConfig

    return ModelConfig.from_hf_config(hf_config_from_gguf(g))


# GGUF tokenizer token_type values (ggml vocab semantics)
_TT_NORMAL, _TT_UNKNOWN, _TT_CONTROL = 1, 2, 3
_TT_USER_DEFINED, _TT_UNUSED, _TT_BYTE = 4, 5, 6


def tokenizer_from_gguf(g: GgufFile):
    """The port's tokenizer (``llm/tokenizer.Tokenizer``) from GGUF
    metadata, as the reference rebuilds a ``tokenizers.Tokenizer``:

    - ``tokenizer.ggml.model == "llama"`` → SentencePiece-semantics
      Unigram over the pieces' scores, with byte fallback and the ▁
      whitespace convention (``spm_unigram_spec``);
    - ``"gpt2"`` → byte-level BPE from the embedded merges.

    CONTROL pieces become special added tokens, USER_DEFINED ones added
    tokens matched whole (GGUF's token_type reuses SentencePiece's piece
    types)."""
    from .tokenizer import Tokenizer, spm_added_tokens, spm_unigram_spec

    md = g.metadata
    tokens = md.get("tokenizer.ggml.tokens")
    if not tokens:
        raise GgufError("GGUF carries no tokenizer.ggml.tokens")
    model_kind = md.get("tokenizer.ggml.model", "llama")
    types = md.get("tokenizer.ggml.token_type") or [_TT_NORMAL] * len(tokens)

    if model_kind == "gpt2":
        merges = [m.split(" ", 1) for m in md.get("tokenizer.ggml.merges") or []
                  if " " in m]
        return Tokenizer({
            "model": {"type": "BPE", "vocab": {t: i for i, t in enumerate(tokens)},
                      "merges": merges},
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "use_regex": True},
            "decoder": {"type": "ByteLevel"},
            "added_tokens": spm_added_tokens(tokens, types),
        })
    if model_kind == "llama":
        scores = md.get("tokenizer.ggml.scores") or [0.0] * len(tokens)
        unk_id = md.get("tokenizer.ggml.unknown_token_id")
        return Tokenizer(spm_unigram_spec(
            tokens, [float(s) for s in scores], list(types), unk_id))
    raise GgufError(f"unsupported GGUF tokenizer model {model_kind!r}")


def mdc_from_gguf(path: str, display_name: Optional[str] = None,
                  kv_block_size: int = 16):
    """ModelDeploymentCard from a .gguf file (reference:
    model_card/create.rs from_gguf)."""
    from .model_card import ModelDeploymentCard, slugify

    g = read_gguf(path)
    name = display_name or g.metadata.get("general.name") or path
    eos = g.metadata.get("tokenizer.ggml.eos_token_id")
    return ModelDeploymentCard(
        display_name=name,
        slug=slugify(str(name)),
        model_path=path,
        context_length=g.arch_key("context_length", 4096),
        kv_block_size=kv_block_size,
        chat_template=g.metadata.get("tokenizer.chat_template"),
        bos_token_id=g.metadata.get("tokenizer.ggml.bos_token_id"),
        eos_token_ids=[eos] if eos is not None else [],
        # HF-shaped so engine_config_from_mdc builds the same ModelConfig
        # a snapshot-backed worker would
        config=hf_config_from_gguf(g),
    )
