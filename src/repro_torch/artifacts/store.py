"""Export / load / verify of MX-quantized artifacts, in the on-disk format
of ``docs/artifact-format.md`` — the same bytes the JAX package writes and
reads, so an artifact exported by either package serves in both.

Export takes a :class:`~repro_torch.core.ptq.PTQResult` whose linear
weights already sit on the MX grid and writes 4-bit codes + E8M0 scale
bytes for them (packing is checked to be lossless), every other leaf in its
logical dtype, and a manifest with content hashes. Load returns a servable
``(params, cfg, qm)`` triple with the quantized weights as
:class:`~repro_torch.kernels.packing.PackedWeight` leaves on the requested
device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import shutil
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.core import mx as mxlib
from repro_torch.core.gptq import WEIGHT_KEYS
from repro_torch.core.quantize import QuantMode
from repro_torch.kernels import packing

from .manifest import (AUX_FILE, MANIFEST_FILE, WEIGHTS_FILE, ArtifactError,
                       IntegrityError, Manifest, TensorRecord, array_sha256)

# logical dtypes numpy cannot hold: stored as raw little-endian uint8 bytes
_RAW_BYTE_DTYPES = {"bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Tree <-> flat-key helpers (params trees are nested dicts)
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _is_quantized_key(key: str, leaf) -> bool:
    """A leaf is a quantized linear weight iff its name is a known weight
    key and it is at least 2-D (contraction axis = -2)."""
    return key.split("/")[-1] in WEIGHT_KEYS and leaf.ndim >= 2


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _raw_sha256(dtype: str, shape, raw: np.ndarray) -> str:
    """``array_sha256`` of a logical array held as its raw bytes."""
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(str(tuple(shape)).encode())
    h.update(np.ascontiguousarray(raw).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# QuantMode (de)serialization
# ---------------------------------------------------------------------------

def _mxcfg_to_json(c):
    if c is None:
        return None
    return {"fmt": c.fmt, "block_size": c.block_size,
            "scale_mode": c.scale_mode, "stochastic": c.stochastic}


def _mxcfg_from_json(d):
    return None if d is None else mxlib.MXConfig(**d)


def quant_mode_to_json(qm: QuantMode) -> dict:
    return {"enabled": qm.enabled,
            "act_cfg": _mxcfg_to_json(qm.act_cfg),
            "weight_cfg": _mxcfg_to_json(qm.weight_cfg),
            "t3_block": qm.t3_block,
            "quantize_head": qm.quantize_head}


def quant_mode_from_json(d: dict) -> QuantMode:
    return QuantMode(enabled=d["enabled"],
                     act_cfg=_mxcfg_from_json(d["act_cfg"]),
                     weight_cfg=_mxcfg_from_json(d["weight_cfg"]),
                     t3_block=d["t3_block"],
                     quantize_head=d["quantize_head"])


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def export_artifact(result, cfg: ArchConfig, out_dir, *,
                    extra: dict | None = None) -> pathlib.Path:
    """Write ``result`` (a PTQResult of torch tensors on any device) as an
    artifact directory and return its path. Packing runs where the weights
    live; only the bytes come to the host. The write is atomic (tmp dir +
    rename). Raises ArtifactError for an unquantized result, a format that
    is not 4-bit packable, or a weight off the MX grid."""
    qm = result.qm
    if not qm.enabled:
        raise ArtifactError(
            "PTQResult is unquantized (method 'fp'); the artifact store "
            "only ships quantized deployments — run a PTQ method first")
    wcfg = qm.weight_cfg or qm.act_cfg
    if wcfg is None:
        raise ArtifactError("QuantMode carries no MXConfig to pack with")
    packing._check_packable(wcfg.fmt, wcfg.block_size, wcfg.scale_mode)
    fmt = wcfg.fmt

    flat = _flatten(result.params)
    weights_npz: Dict[str, np.ndarray] = {}
    aux_npz: Dict[str, np.ndarray] = {}
    records = []
    for key in sorted(flat):
        leaf = flat[key]
        if _is_quantized_key(key, leaf):
            bundle = packing.pack_weight(leaf, fmt)
            rt = packing.unpack_weight(bundle, leaf.dtype)
            if not torch.equal(rt, leaf):
                raise ArtifactError(
                    f"weight {key!r} is not on the {fmt} grid — packing "
                    f"would silently re-quantize it; export only accepts "
                    f"quantized PTQ results")
            codes = bundle["codes_packed"].cpu().numpy()
            scales = bundle["scales_e8m0"].cpu().numpy()
            nb = packing.packed_bundle_nbytes(bundle)
            acct = mxlib.packed_nbytes(
                leaf.shape, mxlib.MXConfig(fmt=fmt, block_size=32))
            if nb != acct:
                raise ArtifactError(
                    f"{key}: packed bytes {nb} != roofline accounting {acct}")
            weights_npz[f"{key}.codes"] = codes
            weights_npz[f"{key}.scales"] = scales
            records.append(TensorRecord(
                key=key, kind="packed", shape=list(leaf.shape),
                dtype=_dtype_name(leaf), fmt=fmt, packed_nbytes=nb,
                sha256_codes=array_sha256(codes),
                sha256_scales=array_sha256(scales)))
        else:
            dt = _dtype_name(leaf)
            leaf = leaf.detach().contiguous().cpu()
            if dt in _RAW_BYTE_DTYPES:
                store = leaf.view(torch.uint8).numpy()
                digest = _raw_sha256(dt, leaf.shape, store)
            else:
                store = leaf.numpy()
                digest = array_sha256(store)
            aux_npz[key] = store
            records.append(TensorRecord(
                key=key, kind="raw", shape=list(leaf.shape), dtype=dt,
                nbytes=int(store.nbytes), sha256=digest))
    if not weights_npz:
        raise ArtifactError("no quantized weights found in PTQResult params")

    man = Manifest(method=result.method, fmt=fmt,
                   arch=dataclasses.asdict(cfg),
                   quant_mode=quant_mode_to_json(qm),
                   tensors=records, extra=extra)

    out = pathlib.Path(out_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f".tmp_artifact_{out.name}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / WEIGHTS_FILE, **weights_npz)
    np.savez(tmp / AUX_FILE, **aux_npz)
    man.save(tmp / MANIFEST_FILE)
    if out.exists():
        shutil.rmtree(out)
    os.replace(tmp, out)              # atomic on POSIX
    return out


# ---------------------------------------------------------------------------
# Load / verify
# ---------------------------------------------------------------------------

def _load_npz(path: pathlib.Path) -> dict:
    """Read every array of an npz store; a corrupt or truncated store
    raises IntegrityError naming the file."""
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise ArtifactError(f"missing {path.name} in artifact directory")
    except Exception as e:  # BadZipFile / truncated / bit-flipped stores
        raise IntegrityError(
            f"artifact tensor file {path.name} is corrupt or truncated "
            f"({type(e).__name__}: {e}) — the artifact cannot be served; "
            f"re-export it or restore the file from backup")


def _raw_digest(t: TensorRecord, arr: np.ndarray) -> str:
    if t.dtype in _RAW_BYTE_DTYPES and arr.dtype == np.uint8:
        return _raw_sha256(t.dtype, t.shape, arr)
    return array_sha256(arr)


def _raw_tensor(t: TensorRecord, arr: np.ndarray) -> torch.Tensor:
    """The logical tensor of a raw record (undoing the uint8 byte view of
    dtypes numpy cannot hold)."""
    if t.dtype in _RAW_BYTE_DTYPES and arr.dtype == np.uint8:
        return (torch.from_numpy(np.ascontiguousarray(arr))
                .view(_RAW_BYTE_DTYPES[t.dtype]).reshape(t.shape))
    return torch.from_numpy(np.ascontiguousarray(arr))


def _read_arrays(root: pathlib.Path, man: Manifest,
                 verify: bool) -> Tuple[dict, dict]:
    weights = _load_npz(root / WEIGHTS_FILE)
    aux = _load_npz(root / AUX_FILE)
    expect_w, expect_a = set(), set()
    for t in man.tensors:
        if t.kind == "packed":
            expect_w.update((f"{t.key}.codes", f"{t.key}.scales"))
        else:
            expect_a.add(t.key)
    if set(weights) != expect_w or set(aux) != expect_a:
        raise IntegrityError(
            f"stored arrays do not match manifest: weights "
            f"{sorted(set(weights) ^ expect_w)}, aux "
            f"{sorted(set(aux) ^ expect_a)} differ")
    if verify:
        for t in man.tensors:
            if t.kind == "packed":
                ok = (array_sha256(weights[f"{t.key}.codes"])
                      == t.sha256_codes
                      and array_sha256(weights[f"{t.key}.scales"])
                      == t.sha256_scales)
            else:
                ok = _raw_digest(t, aux[t.key]) == t.sha256
            if not ok:
                raise IntegrityError(
                    f"content hash mismatch for tensor {t.key!r}: the "
                    f"stored bytes differ from the manifest's sha256 — the "
                    f"file was modified or corrupted after export")
    return weights, aux


def load_artifact(path, *, eager: bool = False, verify: bool = True,
                  backend: str | None = None, device=None
                  ) -> Tuple[dict, ArchConfig, QuantMode]:
    """Load an artifact into a servable ``(params, cfg, qm)`` triple on
    ``device`` (default: the CUDA card; ``"cpu"`` must be asked for).

    eager=False (default): quantized weights are PackedWeight leaves — the
    packed bytes stay packed, consumed by the GEMM kernel under the fused
    backend or decoded at each use under 'ref'. eager=True decodes them
    once at load. verify=True recomputes every content hash first
    (IntegrityError on a mismatch). backend overrides the serving backend
    ('ref' | 'fused'), which the manifest never stores."""
    dev = devices.resolve(device)
    root = pathlib.Path(path)
    man = Manifest.load(root / MANIFEST_FILE)
    weights, aux = _read_arrays(root, man, verify)

    cfg = ArchConfig(**man.arch)
    qm = quant_mode_from_json(man.quant_mode)
    if backend is not None:
        qm = qm.with_backend(backend)

    flat = {}
    for t in man.tensors:
        if t.kind == "packed":
            pw = packing.PackedWeight(
                torch.from_numpy(weights[f"{t.key}.codes"]).to(dev),
                torch.from_numpy(weights[f"{t.key}.scales"]).to(dev),
                t.fmt, t.dtype)
            if list(pw.shape) != list(t.shape):
                raise IntegrityError(
                    f"{t.key}: packed arrays imply shape {pw.shape}, "
                    f"manifest says {t.shape}")
            flat[t.key] = pw.to_dense() if eager else pw
        else:
            flat[t.key] = _raw_tensor(t, aux[t.key]).to(dev)
    return _nest(flat), cfg, qm


def verify_artifact(path) -> dict:
    """Full integrity + accounting check. Raises on any mismatch; returns a
    summary dict."""
    root = pathlib.Path(path)
    man = Manifest.load(root / MANIFEST_FILE)
    weights, _ = _read_arrays(root, man, verify=True)
    stored_packed = sum(int(a.nbytes) for a in weights.values())
    if stored_packed != man.packed_total_nbytes:
        raise IntegrityError(
            f"stored packed bytes {stored_packed} != manifest total "
            f"{man.packed_total_nbytes}")
    for t in man.tensors:
        if t.kind != "packed":
            continue
        acct = mxlib.packed_nbytes(
            t.shape, mxlib.MXConfig(fmt=t.fmt, block_size=32))
        if t.packed_nbytes != acct:
            raise IntegrityError(
                f"{t.key}: manifest packed_nbytes {t.packed_nbytes} != "
                f"roofline accounting {acct}")
    return {"ok": True, "method": man.method, "fmt": man.fmt,
            "n_tensors": len(man.tensors),
            "packed_nbytes": man.packed_total_nbytes,
            "raw_nbytes": man.raw_total_nbytes}
