"""Matrix caching: save / restore of the tuned tables and their plans.

Counterpart of ``sparsex_tpu/persist.py`` (itself the reference library's
``CsxSaveRestore.hpp:76-369``), in the same archive format: one ``.npz``
holding every shard's tables, each shard's paged plan ("layouts") and a
JSON metadata record, under the magic ``sparsex_tpu-csx-v2``, with the same
keys, DIA occupancy masks packed by ``np.packbits`` and layout trees encoded
by ``_enc_tree``.  An archive either package writes restores in the other.

Two things differ from the reference's code, not from its format:

- a layout is saved from the shard's host plan
  (:class:`~sparsex_tpu_torch.ops.exec.HostPlan`, planned again at save),
  whose arrays have the reference's dtypes; the executor's device arrays
  do not (``plan_to_torch`` uploads rows as int32, for example);
- a restored layout is checked before it runs: one that holds a fused run
  whose route instances overlap outside a merged plan (which the port's
  planner re-plans: ROADMAP Queue 3, the intended divergences), or
  anything else ``check_slice`` refuses, is dropped and the shard planned
  again from its tables.

bf16 values: a bf16 array saved by ``np.savez`` (the reference's tables,
``ml_dtypes.bfloat16``) loads as the 2-byte void type ``|V2``.  The port
writes a bf16 matrix's table values as those 2-byte patterns and reads
them back into its bf16-rounded float32 tables (``value_type`` bfloat16).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Tuple

import numpy as np

from sparsex_tpu_torch.csx import CsxMatrix
from sparsex_tpu_torch.device import resolve_device
from sparsex_tpu_torch.errors import ErrorCode, seterror
from sparsex_tpu_torch.logger import log_info, log_warning
from sparsex_tpu_torch.ops.exec import CsxExecutor, HostPlan
from sparsex_tpu_torch.ops.kernels import (check_slice,
                                           unmerged_overlapping_runs)
from sparsex_tpu_torch.parallel.partition import RowPartition
from sparsex_tpu_torch.preprocess.encodings import EncType
from sparsex_tpu_torch.preprocess.tables import (BlockTable, CsxTables,
                                                 DeltaTable, DiagTable,
                                                 RunTable)

# v2: added per-table DIA occupancy masks, dvalues for symmetric archives
# and the partition/permutation arrays (ref persist.py:28-33).
_MAGIC = "sparsex_tpu-csx-v2"
_OLD_MAGICS = ("sparsex_tpu-csx-v1",)
_BF16 = np.dtype("V2")   # how np.load reads an ml_dtypes.bfloat16 array


def _enc_tree(node, arrays: dict, prefix: str):
    """JSON-encodable structure with numpy leaves swapped for archive keys
    (copied from ref persist.py:37-51)."""
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if isinstance(node, np.ndarray):
        arrays[prefix] = node
        return {"__arr__": prefix}
    if isinstance(node, dict):
        return {"__dict__": {k: _enc_tree(v, arrays, f"{prefix}.{k}")
                             for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"__list__" if isinstance(node, list) else "__tuple__":
                [_enc_tree(v, arrays, f"{prefix}.{i}")
                 for i, v in enumerate(node)]}
    raise TypeError(f"unserializable layout node: {type(node)}")


def _dec_tree(node, arrays: dict):
    """Inverse of :func:`_enc_tree` (copied from ref persist.py:54-65)."""
    if not isinstance(node, dict):
        return node
    if "__arr__" in node:
        return arrays[node["__arr__"]]
    if "__dict__" in node:
        return {k: _dec_tree(v, arrays) for k, v in node["__dict__"].items()}
    if "__list__" in node:
        return [_dec_tree(v, arrays) for v in node["__list__"]]
    if "__tuple__" in node:
        return tuple(_dec_tree(v, arrays) for v in node["__tuple__"])
    return node


def bf16_bits(vals: np.ndarray) -> np.ndarray:
    """bf16-rounded float32 values as the 2-byte bf16 patterns (``|V2``)
    an ``ml_dtypes.bfloat16`` array is saved as (its high 16 bits)."""
    u = np.ascontiguousarray(vals, dtype=np.float32).view(np.uint32)
    return (u >> 16).astype(np.uint16).view(_BF16)


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """The float32 values of 2-byte bf16 patterns (:func:`bf16_bits`)."""
    u = np.ascontiguousarray(bits).view(np.uint16).astype(np.uint32)
    return (u << 16).view(np.float32)


def _vals_out(vals, bf16: bool) -> np.ndarray:
    return bf16_bits(vals) if bf16 else vals


def _vals_in(vals: np.ndarray) -> np.ndarray:
    return bf16_values(vals) if vals.dtype == _BF16 else vals


def save_csx(mat: CsxMatrix, filename: str,
             permutation: Optional[np.ndarray] = None,
             include_layouts: bool = True) -> None:
    """``spx_mat_save`` parity (ref persist.py:68-145): every shard's
    tables and, with ``include_layouts``, each shard's paged plan, so that
    restore skips planning (a symmetric matrix saves its ``dvalues`` and no
    layouts)."""
    arrays = {}
    bf16 = bool(mat.shards) and mat.shards[0].value_type == "bfloat16"
    meta = {
        "magic": _MAGIC,
        "nrows": mat.nrows,
        "ncols": mat.ncols,
        "nnz": mat.nnz,
        "symmetric": mat.symmetric,
        "nshards": len(mat.shards),
        "shards": [],
    }
    for i, t in enumerate(mat.shards):
        meta["shards"].append({
            "nrows": t.nrows, "ncols": t.ncols, "nnz": t.nnz,
            "row_start": t.row_start,
            "has_delta": t.delta is not None,
            "runs": [{"enc": int(r.enc), "delta": r.delta} for r in t.runs],
            "blocks": [{"enc": int(b.enc)} for b in t.blocks],
            "dias": [{"anti": d.anti, "nnz": d.nnz_count} for d in t.dias],
        })
        if t.delta is not None:
            arrays[f"s{i}_d_rowptr"] = t.delta.rowptr
            arrays[f"s{i}_d_cols"] = t.delta.cols
            arrays[f"s{i}_d_vals"] = _vals_out(t.delta.vals, bf16)
            arrays[f"s{i}_d_rowids"] = t.delta.row_ids
        for j, r in enumerate(t.runs):
            arrays[f"s{i}_r{j}_rows"] = r.rows
            arrays[f"s{i}_r{j}_cols"] = r.cols
            arrays[f"s{i}_r{j}_sizes"] = r.sizes
            arrays[f"s{i}_r{j}_vals"] = _vals_out(r.vals, bf16)
        for j, b in enumerate(t.blocks):
            arrays[f"s{i}_b{j}_rows"] = b.rows
            arrays[f"s{i}_b{j}_cols"] = b.cols
            arrays[f"s{i}_b{j}_vals"] = _vals_out(b.vals, bf16)
        for j, d in enumerate(t.dias):
            arrays[f"s{i}_g{j}_offsets"] = d.offsets
            arrays[f"s{i}_g{j}_vals"] = _vals_out(d.vals, bf16)
            arrays[f"s{i}_g{j}_mask"] = np.packbits(d.mask, axis=None)
    if mat.symmetric:
        for i, dv in enumerate(mat.dvalues):
            arrays[f"s{i}_dvalues"] = _vals_out(dv, bf16)
    if include_layouts and not mat.symmetric:
        layouts = []
        for i, t in enumerate(mat.shards):
            plan = HostPlan(t)
            plan._maybe_build_pages()
            if plan._pages_meta is None:
                layouts.append(None)
                continue
            layouts.append({
                "meta": _enc_tree(plan._pages_meta, arrays, f"s{i}_Lm"),
                "arrays": _enc_tree(plan._pages_arrays, arrays, f"s{i}_La"),
            })
        if any(lay is not None for lay in layouts):
            meta["layouts"] = layouts
    if permutation is not None:
        arrays["permutation"] = np.asarray(permutation)
    if mat.partition is not None:
        meta["partition"] = {
            "row_start": [int(v) for v in mat.partition.row_start],
            "row_end": [int(v) for v in mat.partition.row_end],
            "nnz": [int(v) for v in mat.partition.nnz_per_part],
        }
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    try:
        np.savez_compressed(filename, **arrays)
    except OSError as e:
        seterror(ErrorCode.SPX_ERR_FILE_WRITE, f"cannot write {filename}: {e}")


def _load(filename: str):
    """The archive's arrays and metadata (ref persist.py:150-172)."""
    try:
        # np.savez_compressed appends ".npz" when missing; mirror that on
        # load so save/restore accept the same filename.
        if not os.path.exists(filename) and os.path.exists(filename + ".npz"):
            filename = filename + ".npz"
        with np.load(filename) as data:
            arrays = {k: data[k] for k in data.files}
    except OSError as e:
        seterror(ErrorCode.SPX_ERR_FILE_READ, f"cannot read {filename}: {e}")
    try:
        meta = json.loads(bytes(arrays["meta"]).decode("utf-8"))
        magic = meta["magic"]
    except Exception:
        seterror(ErrorCode.SPX_ERR_FILE_READ,
                 f"{filename} is not a sparsex_tpu CSX archive")
    if magic != _MAGIC:
        if magic in _OLD_MAGICS:
            seterror(ErrorCode.SPX_ERR_FILE_READ,
                     f"{filename} uses archive format '{magic}'; this "
                     f"build reads '{_MAGIC}' — re-save with mat_save")
        seterror(ErrorCode.SPX_ERR_FILE_READ,
                 f"{filename} is not a sparsex_tpu CSX archive")
    return arrays, meta


def _tables(arrays: dict, i: int, smeta: dict,
            value_type: Optional[str]) -> CsxTables:
    """Shard ``i``'s ``CsxTables`` (ref persist.py:187-219)."""

    def vals(key):
        return _vals_in(arrays[key])

    delta = None
    if smeta["has_delta"]:
        delta = DeltaTable(rowptr=arrays[f"s{i}_d_rowptr"],
                           cols=arrays[f"s{i}_d_cols"],
                           vals=vals(f"s{i}_d_vals"),
                           row_ids=arrays[f"s{i}_d_rowids"])
    runs = [RunTable(enc=EncType(rm["enc"]), delta=rm["delta"],
                     rows=arrays[f"s{i}_r{j}_rows"],
                     cols=arrays[f"s{i}_r{j}_cols"],
                     sizes=arrays[f"s{i}_r{j}_sizes"],
                     vals=vals(f"s{i}_r{j}_vals"))
            for j, rm in enumerate(smeta["runs"])]
    blocks = [BlockTable(enc=EncType(bm["enc"]),
                         rows=arrays[f"s{i}_b{j}_rows"],
                         cols=arrays[f"s{i}_b{j}_cols"],
                         vals=vals(f"s{i}_b{j}_vals"))
              for j, bm in enumerate(smeta["blocks"])]
    dias = []
    for j, dm in enumerate(smeta.get("dias", [])):
        v = vals(f"s{i}_g{j}_vals")
        mask = np.unpackbits(arrays[f"s{i}_g{j}_mask"],
                             count=v.size).reshape(v.shape).astype(bool)
        dias.append(DiagTable(anti=dm["anti"],
                              offsets=arrays[f"s{i}_g{j}_offsets"],
                              vals=v, mask=mask, nnz_count=dm["nnz"]))
    return CsxTables(nrows=smeta["nrows"], ncols=smeta["ncols"],
                     nnz=smeta["nnz"], row_start=smeta["row_start"],
                     delta=delta, runs=runs, blocks=blocks, dias=dias,
                     value_type=value_type)


def restored_plan(tables: CsxTables, layout, arrays: dict,
                  label: str = "") -> HostPlan:
    """The host plan of a restored shard: its archived layout, unless that
    layout holds what the port does not run as it is (a fused run whose
    route instances overlap outside a merged plan, or anything else
    ``check_slice`` refuses); then the shard is planned again from its
    tables."""
    plan = HostPlan(tables)
    if layout is None:
        return plan
    meta = _dec_tree(layout["meta"], arrays)
    why = None
    if unmerged_overlapping_runs(meta):
        why = (f"fused run tables {unmerged_overlapping_runs(meta)} whose "
               "route instances overlap outside a merged plan")
    else:
        try:
            check_slice(meta)
        except NotImplementedError as e:
            why = str(e)
    if why is not None:
        log_warning("restored layout of %s: %s; planned again from its "
                    "tables", label or "a shard", why)
        return plan
    plan._pages_meta = meta
    plan._pages_arrays = _dec_tree(layout["arrays"], arrays)
    plan._pages_tried = True   # the planning cost is amortised
    return plan


def restore_csx(filename: str, device=None
                ) -> Tuple[CsxMatrix, Optional[np.ndarray]]:
    """``spx_mat_restore`` parity (ref persist.py:148-234): the matrix on
    ``device`` (default ``cuda:0``), each shard's executor built from its
    archived layout (:func:`restored_plan`); a symmetric archive restores
    to a ``SymCsxMatrix`` with the executor of the mode in use."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    arrays, meta = _load(filename)
    if meta["symmetric"]:
        from sparsex_tpu_torch.symmetric import SymCsxMatrix
        mat = SymCsxMatrix(nrows=meta["nrows"], ncols=meta["ncols"],
                           nnz=meta["nnz"], device=dev)
        try:
            mat.dvalues = [_vals_in(arrays[f"s{i}_dvalues"])
                           for i in range(meta["nshards"])]
        except KeyError:
            seterror(ErrorCode.SPX_ERR_FILE_READ,
                     f"{filename}: symmetric archive missing dvalues")
    else:
        mat = CsxMatrix(nrows=meta["nrows"], ncols=meta["ncols"],
                        nnz=meta["nnz"], device=dev)
    # a bf16 matrix's values are the archive's only 2-byte arrays
    vtype = ("bfloat16" if any(a.dtype == _BF16 for a in arrays.values())
             else None)
    layouts = meta.get("layouts") or []
    for i, smeta in enumerate(meta["shards"]):
        tables = _tables(arrays, i, smeta, vtype)
        mat.shards.append(tables)
        if meta["symmetric"]:
            continue
        layout = layouts[i] if i < len(layouts) else None
        mat.executors.append(CsxExecutor.from_plan(
            restored_plan(tables, layout, arrays, f"shard {i}"), dev))
    if "partition" in meta:
        p = meta["partition"]
        mat.partition = RowPartition(
            nparts=len(p["row_start"]), row_start=p["row_start"],
            row_end=p["row_end"], nnz_per_part=p["nnz"])
    if meta["symmetric"]:
        mat._executor()
    log_info("restored %s: %d shards on %s in %.3f s", filename,
             len(mat.shards), dev, time.perf_counter() - t0)
    return mat, arrays.get("permutation")


__all__ = ["bf16_bits", "bf16_values", "restore_csx", "restored_plan",
           "save_csx"]
