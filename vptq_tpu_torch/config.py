"""Configuration dataclasses for VPTQ-quantized layers.

A copy of ``vptq_tpu/config.py`` (which the port may not import). It
mirrors the constructor surface of the reference ``VQuantLinear``
(reference: vptq/layers/vqlinear.py:56-240) so that community
checkpoints' ``quantization_config`` blocks (reference:
vptq/layers/model_base.py:113-115) can be ingested verbatim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class VQLinearConfig:
    """Static geometry of one vector-quantized linear layer.

    Field names/order follow the reference ctor kwargs
    (vqlinear.py:56-75) so ``VQLinearConfig(**layer_conf)`` works on the
    dicts found in checkpoint ``config_for_layers`` /
    ``shared_layer_config``.
    """

    in_features: int
    out_features: int
    # (outlier_component, main_component) — reference vqlinear.py:98-121.
    vector_lens: Tuple[int, int]
    num_centroids: Tuple[int, int]
    num_res_centroids: Tuple[int, int]
    # group_num == num_codebooks (legacy alias, vqlinear.py:103-105).
    group_num: int
    group_size: int
    outlier_size: int
    indices_as_float: bool = False
    enable_norm: bool = False
    enable_perm: bool = False
    is_indice_packed: bool = False
    bias: bool = False
    vector_quant_dim: str = "out"

    def __post_init__(self):
        if self.vector_quant_dim != "out":
            raise NotImplementedError(
                "Only vector_quant_dim='out' is supported "
                "(matches reference vqlinear.py:80-81)."
            )

    # --- derived geometry (reference vqlinear.py:100-240) -------------

    @property
    def vector_len(self) -> int:
        return self.vector_lens[1]

    @property
    def num_main_centroids(self) -> int:
        return self.num_centroids[1]

    @property
    def num_codebooks(self) -> int:
        return self.group_num

    @property
    def outlier_vector_len(self) -> int:
        return self.vector_lens[0]

    @property
    def num_outlier_centroids(self) -> int:
        return self.num_centroids[0]

    @property
    def enable_outlier(self) -> bool:
        return self.outlier_vector_len > 1 and self.num_outlier_centroids > 0

    @property
    def num_main_res_centroids(self) -> int:
        return self.num_res_centroids[1]

    @property
    def enable_residual(self) -> bool:
        return self.num_main_res_centroids > 0

    @property
    def padding(self) -> int:
        return (-self.out_features) % self.vector_len

    @property
    def num_indices(self) -> int:
        return (self.out_features + self.padding) // self.vector_len

    @property
    def outlier_padding(self) -> int:
        if not self.enable_outlier:
            return 0
        return (-self.out_features) % self.outlier_vector_len

    @property
    def outlier_num_indices(self) -> int:
        if not self.enable_outlier:
            return 0
        return (
            self.out_features + self.outlier_padding
        ) // self.outlier_vector_len

    @property
    def index_bits(self) -> int:
        return int(math.ceil(math.log2(self.num_main_centroids)))

    @property
    def res_index_bits(self) -> int:
        if not self.enable_residual:
            return 0
        return int(math.ceil(math.log2(self.num_main_res_centroids)))

    @property
    def total_index_bits(self) -> int:
        return self.index_bits + self.res_index_bits

    @property
    def packed_group_size(self) -> int:
        """Words per packed index row (reference vqlinear.py:225-227)."""
        return _ceil_div(self.group_size * self.total_index_bits, 32)

    @property
    def equivalent_bits(self) -> float:
        """Effective bits/weight, README.md:143-159 formula."""
        bits = self.index_bits / self.vector_len
        if self.enable_residual:
            bits += self.res_index_bits / self.vector_len
        return bits

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VQLinearConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        for key in ("vector_lens", "num_centroids", "num_res_centroids"):
            if key in kwargs and isinstance(kwargs[key], list):
                kwargs[key] = tuple(kwargs[key])
        if isinstance(kwargs.get("bias"), (list, dict)):
            kwargs["bias"] = True  # tensor serialized in old configs
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for key in ("vector_lens", "num_centroids", "num_res_centroids"):
            d[key] = list(d[key])
        return d


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Parsed ``quantization_config`` block of a VPTQ HF checkpoint.

    Layer lookup order matches reference model_base.py:41-47: exact module
    path first, then the tail name in ``shared_layer_config``.
    """

    config_for_layers: Dict[str, VQLinearConfig]
    shared_layer_config: Dict[str, VQLinearConfig]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantizationConfig":
        method = d.get("quant_method")
        if method not in (None, "vptq"):
            raise ValueError(f"not a VPTQ checkpoint: quant_method={method}")
        per_layer = {
            name: VQLinearConfig.from_dict(conf)
            for name, conf in d.get("config_for_layers", {}).items()
        }
        shared = {
            name: VQLinearConfig.from_dict(conf)
            for name, conf in d.get("shared_layer_config", {}).items()
        }
        return cls(config_for_layers=per_layer, shared_layer_config=shared)

    def lookup(self, module_path: str) -> Optional[VQLinearConfig]:
        conf = self.config_for_layers.get(module_path)
        if conf is None:
            tail = module_path.split(".")[-1]
            conf = self.shared_layer_config.get(tail)
        return conf
