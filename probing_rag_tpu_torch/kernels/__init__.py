"""Build and load layer for the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source (per part of a source that names parts), all
started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``_build/`` beside this file, and is reused while
a hash of the sources and flags is unchanged. Nothing is built or imported
when this module is imported, so the CPU tests can import every module.

Every C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it. A run
resets the counts with :func:`reset_launches` and reads them afterwards to
show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "bm25_gather": 0,
    "bitonic_sort": 0,
    "bitonic_sort_wide": 0,
    "segment_topk": 0,
    "dense_topk": 0,
    "ivf_topk": 0,
    "matmul_int8": 0,
    "matmul_int4": 0,
    "postings_gather": 0,
    "postings_assemble": 0,
    "decode_attention": 0,
    "prefill_attention": 0,
    "rms_norm": 0,
    "rope_kv": 0,
    "gated_act": 0,
    "layer_norm": 0,
    "bias_gelu": 0,
    "gelu_table": 0,
    "qkv_heads": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "bm25_gather": [_P] * 15 + [_I, _I, _LL, _I, _I, _P, _P, _P],
    # keys in, values in, keys out, values out, q, p, row strides in and
    # out, then tile, k_lo, k_hi, tile_asc | run, desc_odd, rev_odd; stream
    "sort_tile_pass": [_P] * 4 + [_I] + [_LL] * 3 + [_I, _LL, _LL, _I, _P],
    "sort_merge_pass": [_P] * 4 + [_I] + [_LL] * 4 + [_I, _I, _P],
    # doc, imp, q, p, k, sentinel, chunk, nchunks, partial v/i, out v/i, stream
    "segment_topk": [_P, _P, _I, _LL, _I, _I, _LL, _I] + [_P] * 5,
    # q, store, sqn, scales; mode, regime, nq, n, d, qt, ntile, chunk_rows,
    # nchunks, kp, stages, boxes, cap, resident, smem; partial v/i, out v/i,
    # stream
    "dense_topk": [_P] * 4 + [_I, _I, _I, _LL, _I, _I, _I, _LL] + [_I] * 7 + [_P] * 5,
    # q, desc, store, ids, sqn, scales; mode, regime, nt, pb, pieces,
    # per_split, nsplit, block, d, pad_block, k, stages, smem; partial v/i,
    # out v/i, stream
    "ivf_topk": [_P] * 6 + [_I] * 13 + [_P] * 5,
    # x, q, s, out; mode, transpose, regime, m, n, k, bm, bn, splits, grid;
    # stream
    "matmul_int8": [_P] * 4 + [_I, _I, _I, _LL] + [_I] * 6 + [_P],
    # x, arrays of qp, rs, s, gs, out pointers and of widths n; count; the
    # scratch (the wgmma regime's xs, the stream regime's partial sums);
    # mode, fn, regime, m, k, group, bm, bn, splits, grid, stages, xsteps;
    # the stream regime's tile counters; stream
    "matmul_int4": [_P] * 7 + [_I, _P, _I, _I, _I, _LL] + [_I] * 8 + [_P, _P],
    "postings_gather": [_P] * 7 + [_I, _I, _LL, _I, _I, _P, _P, _P],
    # doc_c, imp_c, src, rlen, wt; q, tq, pad, ld, span, sentinel; out doc/imp, stream
    "postings_assemble": [_P] * 5 + [_I, _I, _LL, _LL, _LL, _I, _P, _P, _P],
    # q, k, v, k/v scales, mask, scores, part m/l/o, out; kind, round_bf16, b,
    # kvh, g, t, s, hd, grp; cache, scale and mask strides; tiles_per_split,
    # nsplit, scale, stream
    "decode_attention": [_P] * 11 + [_I] * 9 + [_LL] * 6 + [_I, _I, _F, _P],
    # q, k, v, k/v scales, qpos, kpos, valid, keff, tmin, vpart, vsum, out;
    # kind, b, kvh, g, t, s, hd, grp; cache and scale strides; the plan's
    # tile, stages, raw_slots, raw_stages, smem, regime, grid; out_bf16,
    # scale, stream
    "prefill_attention": [_P] * 13 + [_I] * 8 + [_LL] * 4 + [_I] * 8 + [_F, _P],
    # x, delta, w, resid, normed; delta / weight / out kinds, rows, d, eps,
    # plus_one, the plan's width, rows_block, blocks, chunk; stream
    "rms_norm": [_P] * 5 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # q, k, v, positions, cursor, k / v cache, k / v scales; dt, kind, b, t,
    # h, kvh, hd, s, group; positions', cache and scale strides; theta, the
    # plan's vec_bytes, lanes_row, steps_warp, warps_token, tokens_block,
    # blocks; stream
    "rope_kv": [_P] * 9 + [_I] * 9 + [_LL] * 6 + [_F] + [_I] * 6 + [_P],
    # gate, up, out; dt, act, n, the plan's vec_bytes, threads, blocks;
    # stream
    "gated_act": [_P] * 3 + [_I, _I, _LL] + [_I] * 3 + [_P],
    # resid, delta, bias, w, b, out, xin; rows, d, eps, the plan's per,
    # warps, blocks; stream
    "layer_norm": [_P] * 7 + [_I, _I, _F] + [_I] * 3 + [_P],
    # h, bias, table; rows, f, the plan's vec, threads, blocks, unroll,
    # win_lo, win_len; stream
    "bias_gelu": [_P] * 3 + [_I] * 8 + [_P],
    # table; stream
    "gelu_table": [_P, _P],
    # y, bq, bk, bv, q, k, v; b, t, h, hd, the plan's vec, threads, blocks;
    # stream
    "qkv_heads": [_P] * 7 + [_I] * 7 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _parts(src: Path) -> int:
    """The ``// nvcc-parts: K`` line of a source: it compiles K times, with
    ``-DNVCC_PART=0 .. K-1 -DNVCC_PARTS=K`` (1 without the line)."""
    found = re.search(r"^// nvcc-parts: (\d+)$", src.read_text(), re.M)
    return int(found.group(1)) if found else 1


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libprobing_kernels_<hash>.so``
    unless that file exists. Returns its path. Each source (each part of a
    source that names parts, see :func:`_parts`) compiles in its own
    ``nvcc`` process, all at once; one more call links the objects.
    With ``verbose``, prints the build time and ``ptxas`` resource usage
    (registers, shared memory, spills) of each kernel."""
    cu, cuh = _sources()
    digest = hashlib.sha256()
    for f in (*cu, *cuh):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libprobing_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    t0 = time.time()
    objs, procs = [], []
    for src in cu:
        parts = _parts(src)
        for part in range(parts):
            obj = BUILD_DIR / f"{src.stem}.{part}.{tag}.o"
            defs = [f"-DNVCC_PART={part}", f"-DNVCC_PARTS={parts}"] if parts > 1 else []
            cmd = [_nvcc(), *NVCC_FLAGS, *defs, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    logs = []
    for cmd, proc in procs:  # wait for every compile before reporting
        out, err = proc.communicate()
        logs.append((cmd, proc.returncode, out, err))
    failed = [f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}\n{err}"
              for cmd, rc, out, err in logs if rc != 0]
    if failed:  # every failing compile, not only the first
        raise RuntimeError("\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    link = subprocess.run(cmd, capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({link.returncode}):\n{' '.join(cmd)}\n"
            f"{link.stdout}\n{link.stderr}"
        )
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    so.with_suffix(".ptxas.txt").write_text(
        "".join(f"== {Path(cmd[-1]).name} {' '.join(c for c in cmd if c.startswith('-DNVCC_PART='))}"
                f"\n{err}\n" for cmd, _, _, err in logs))
    if verbose:
        print(f"built {so.name} from {len(cu)} sources in {time.time() - t0:.1f}s")
        for _, _, _, err in logs:
            print(err.strip())
    return so


def ptxas_usage(kernel: str) -> list:
    """``ptxas -v``'s report of every entry function whose mangled name
    holds ``kernel``, from the log :func:`build` keeps beside the library:
    dicts of ``name``, ``template`` (its integer template arguments),
    ``registers``, ``spill_stores``, ``spill_loads`` (bytes), and the
    compile's ``warnings`` (ptxas lines naming the function or its file)."""
    log = build().with_suffix(".ptxas.txt").read_text()
    found, cur, warn_by_file, file = [], None, {}, ""
    for line in log.splitlines():
        if line.startswith("== "):
            file = line[3:]
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            if kernel in m.group(1):
                cur = {"name": m.group(1), "file": file,
                       "template": [int(x) for x in re.findall(r"Li(-?\d+)E", m.group(1))],
                       "registers": None, "spill_stores": None, "spill_loads": None}
                found.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None and cur["spill_stores"] is None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None and cur["registers"] is None:
            cur["registers"] = int(m.group(1))
            continue
        if "warning" in line.lower():
            warn_by_file.setdefault(file, []).append(line.strip())
    for f in found:
        f["warnings"] = [w for w in warn_by_file.get(f["file"], []) if kernel in w or "C75" in w]
    return found


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``: the dense kernels split
    their work into a few thread blocks per SM."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, for the C entries. The
    caller launches with ``device`` current (``torch.cuda.device``)."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
