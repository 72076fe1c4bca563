"""Artifact manifest: the JSON contract between export and serving.

An artifact directory is the unit of deployment (calibrate once, fold,
quantize, export — then every serving run loads the same bytes):

    artifact/
      manifest.json     schema + arch + quant mode + per-tensor records
      weights.npz       packed quantized weights: "<key>.codes" uint8
                        (K//2 two-per-byte nibbles, contraction axis) and
                        "<key>.scales" uint8 (E8M0, one per 32-block)
      aux.npz           non-quantized leaves (norms, embeddings, head,
                        biases, folded input transforms) in fp16/fp32

Every stored array carries a sha256 content hash in the manifest, and the
manifest records the packed byte totals so `verify` can cross-check the
on-disk layout against the roofline accounting (`mx.packed_nbytes`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import List, Optional

import numpy as np

SCHEMA_VERSION = 1
ARTIFACT_KIND = "mx-quantized-checkpoint"

MANIFEST_FILE = "manifest.json"
WEIGHTS_FILE = "weights.npz"
AUX_FILE = "aux.npz"


class ArtifactError(RuntimeError):
    """Malformed, unsupported, or incompatible artifact."""


class IntegrityError(ArtifactError):
    """Stored bytes do not match the manifest's content hashes."""


def array_sha256(a: np.ndarray) -> str:
    """Content hash of an array: dtype + shape + raw bytes (C order)."""
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(tuple(a.shape)).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class TensorRecord:
    """One params-tree leaf. kind='packed' leaves store two arrays in
    weights.npz; kind='raw' leaves store one array in aux.npz."""

    key: str                     # '/'-joined tree path, e.g. "blocks/wq"
    kind: str                    # 'packed' | 'raw'
    shape: List[int]             # logical (dense) shape
    dtype: str                   # logical dtype the leaf dequantizes to
    fmt: Optional[str] = None    # element format for packed leaves
    packed_nbytes: Optional[int] = None
    nbytes: Optional[int] = None
    sha256_codes: Optional[str] = None
    sha256_scales: Optional[str] = None
    sha256: Optional[str] = None

    def to_json(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_json(cls, d: dict) -> "TensorRecord":
        return cls(**d)


@dataclasses.dataclass
class Manifest:
    method: str                  # PTQ method that produced the weights
    fmt: str                     # MX element format of the packed weights
    arch: dict                   # dataclasses.asdict(ArchConfig)
    quant_mode: dict             # QuantMode fields (act_cfg/weight_cfg dicts)
    tensors: List[TensorRecord]
    schema_version: int = SCHEMA_VERSION
    kind: str = ARTIFACT_KIND
    extra: Optional[dict] = None

    @property
    def packed_total_nbytes(self) -> int:
        return sum(t.packed_nbytes or 0 for t in self.tensors)

    @property
    def raw_total_nbytes(self) -> int:
        return sum(t.nbytes or 0 for t in self.tensors)

    def record(self, key: str) -> TensorRecord:
        for t in self.tensors:
            if t.key == key:
                return t
        raise ArtifactError(f"no tensor record for {key!r}")

    def to_json(self) -> dict:
        return {
            "schema_version": self.schema_version,
            "kind": self.kind,
            "method": self.method,
            "fmt": self.fmt,
            "arch": self.arch,
            "quant_mode": self.quant_mode,
            "totals": {"packed_nbytes": self.packed_total_nbytes,
                       "raw_nbytes": self.raw_total_nbytes,
                       "n_packed": sum(1 for t in self.tensors
                                       if t.kind == "packed"),
                       "n_raw": sum(1 for t in self.tensors
                                    if t.kind == "raw")},
            "tensors": [t.to_json() for t in self.tensors],
            "extra": self.extra or {},
        }

    @classmethod
    def from_json(cls, d: dict) -> "Manifest":
        if d.get("kind") != ARTIFACT_KIND:
            raise ArtifactError(f"not an MX artifact (kind={d.get('kind')!r})")
        ver = d.get("schema_version")
        if ver != SCHEMA_VERSION:
            raise ArtifactError(
                f"unsupported artifact schema_version {ver} "
                f"(this build reads {SCHEMA_VERSION})")
        return cls(method=d["method"], fmt=d["fmt"], arch=d["arch"],
                   quant_mode=d["quant_mode"],
                   tensors=[TensorRecord.from_json(t) for t in d["tensors"]],
                   schema_version=ver, kind=d["kind"],
                   extra=d.get("extra") or None)

    def save(self, path: pathlib.Path):
        path.write_text(json.dumps(self.to_json(), indent=1, sort_keys=False))

    @classmethod
    def load(cls, path: pathlib.Path) -> "Manifest":
        try:
            d = json.loads(path.read_text())
        except FileNotFoundError:
            raise ArtifactError(f"no {MANIFEST_FILE} under {path.parent} "
                                f"(not an artifact directory?)")
        except json.JSONDecodeError as e:
            raise ArtifactError(f"corrupt manifest {path}: {e}")
        return cls.from_json(d)
