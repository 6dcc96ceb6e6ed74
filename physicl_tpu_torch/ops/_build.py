"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into the git-ignored
``_build/`` directory next to this package, and loaded with ``ctypes``. All
sources compile at once (one ``nvcc`` process each, started together). A
library's name carries a hash of the sources, the shared headers and the
flags, so an edited source never loads a stale build. Nothing here runs at
import time: importing the package needs no ``nvcc`` and no card.

A plan with user ops (kernel 1i) runs a library of its own: the source
``ops/codegen.py`` generates for it, built with the same flags by
:func:`load_plan` (or started ahead by :func:`start_plan_builds`) into
``_build/`` under a hash of that source, every ``csrc/`` file and the
flags, and loaded once per process. Deleting ``_build/`` clears every
build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = None
build_seconds = None   # wall time of this process's build (None: not built)
build_log = ""         # nvcc's output (``-Xptxas -v`` register/spill report)

# the kernel structs of csrc/fused_transport.cu, member for member: the
# grid pointers lead the plan and every other member is 4 bytes wide, so
# both sides lay them out alike (the binding checks the sizes agree)
MAX_OPS = 32
MAX_AXES = 32
MAX_FIELDS = 16
MAX_PROG = 256
ROT_STEPS = 27  # the azimuth bisection's rotation table, k = 0 .. 26
_ci, _cf = ctypes.c_int, ctypes.c_float


class OpStruct(ctypes.Structure):
    _fields_ = [("kind", _ci), ("col0", _ci), ("col1", _ci), ("flag", _ci),
                ("coef", _cf), ("wl_base", _cf), ("c_val", _cf),
                ("emit_n", _ci), ("emit_row", _ci), ("icdf", _ci),
                ("emit_E", _cf), ("emit_scale", _cf),
                ("emit_r", _cf * 3), ("emit_v", _cf * 3),
                ("ax0", _ci), ("n_ax", _ci),
                ("nf", _ci), ("af", _ci), ("capture", _ci),
                ("w_min", _cf), ("w_sur", _cf), ("box", _cf * 6),
                ("fld", _ci * 6)]


class AxisStruct(ctypes.Structure):
    _fields_ = [("axis", _ci), ("L", _cf), ("col", _ci), ("ecol", _ci),
                ("ecap", _ci)]


class FieldStruct(ctypes.Structure):
    _fields_ = [("kind", _ci), ("interp", _ci), ("n", _ci * 3),
                ("org", _cf * 3), ("sp", _cf * 3), ("outside", _cf),
                ("axis", _ci), ("ctr", _cf * 3), ("off", _ci), ("len", _ci)]


class InsStruct(ctypes.Structure):
    _fields_ = [("code", _ci), ("val", _cf)]


class PlanStruct(ctypes.Structure):
    _fields_ = [("grids", ctypes.c_void_p * MAX_FIELDS),
                ("ops", OpStruct * MAX_OPS), ("axes", AxisStruct * MAX_AXES),
                ("fields", FieldStruct * MAX_FIELDS),
                ("prog", InsStruct * MAX_PROG),
                ("n_ops", _ci), ("n_cols", _ci), ("n_fcols", _ci),
                ("const_norm", _ci), ("const_speed", _cf),
                ("n_stream", _ci), ("stream_every", _ci),
                ("stream_bf16", _ci), ("n_extras", _ci), ("otype_x", _ci),
                ("wb_mask", _ci),
                ("rot_sd", _cf * ROT_STEPS), ("rot_cd", _cf * ROT_STEPS),
                ("uwb_mask", _ci)]


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC): the CUDA "
                       "kernels are built from csrc/ at first use")


def _csrc(ext: str):
    return sorted(os.path.join(_CSRC, n) for n in os.listdir(_CSRC)
                  if n.endswith(ext))


def _bind_transport(ft) -> None:
    """The C interface of a fused_transport library (the main one or a user
    plan's), after checking its Plan against the ctypes mirror."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ft.fused_transport_plan_size.restype = ci
    ft.fused_transport_plan_size.argtypes = []
    size = ft.fused_transport_plan_size()
    if size != ctypes.sizeof(PlanStruct):
        raise RuntimeError(f"fused_transport's Plan is {size} B but the "
                           f"ctypes mirror is {ctypes.sizeof(PlanStruct)} B")
    ft.fused_transport_grid.restype = ci
    ft.fused_transport_grid.argtypes = [ll, ci, ci, ci, ci,
                                        ctypes.POINTER(ci)]
    ft.fused_transport_launch.restype = ci
    ft.fused_transport_launch.argtypes = [
        vp, vp, ll, vp, ci, vp, vp, ci, vp, ci, ctypes.c_uint,
        ctypes.POINTER(PlanStruct), ci, ci, vp, vp, vp, vp, ci, ci, vp]


def _bind(libs) -> None:
    vp, cf, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
    ft = libs["fused_transport"]
    _bind_transport(ft)
    ft.fused_transport_rsqrt_check.restype = ctypes.c_int
    ft.fused_transport_rsqrt_check.argtypes = [vp, vp]
    pg = libs["planck_gen"]
    pg.planck_gen_launch.restype = ctypes.c_int
    pg.planck_gen_launch.argtypes = [vp, ll, ctypes.c_uint, vp, cf, vp]


def _sources_hash():
    """sha1 of the flags and every ``csrc/`` source: a library built from
    them carries its hexdigest (plus its own source's) in its name."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _csrc(".cuh") + _csrc(".cu"):
        with open(src, "rb") as f:
            h.update(f.read())
    return h


def _nvcc_cmd(src: str, out: str) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-Xptxas", "-v", "-o", out,
            src]


def load():
    """Build (once per source hash) and load every kernel library; returns
    ``{name: ctypes.CDLL}`` keyed by source file stem."""
    global _libs, build_seconds, build_log
    with _lock:
        if _libs is not None:
            return _libs
        common = _sources_hash()
        jobs = {}
        for src in _csrc(".cu"):
            name = os.path.splitext(os.path.basename(src))[0]
            h = common.copy()
            h.update(name.encode())
            so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")
            jobs[name] = (src, so)
        todo = {n: j for n, j in jobs.items() if not os.path.exists(j[1])}
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            procs = {}
            for name, (src, so) in todo.items():
                tmp = f"{so}.{os.getpid()}.tmp"
                procs[name] = (subprocess.Popen(
                    _nvcc_cmd(src, tmp), stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True), tmp, so)
            logs, failed = [], []
            for name, (proc, tmp, so) in procs.items():
                out, _ = proc.communicate()
                logs.append(f"[{name}]\n{out}")
                if proc.returncode != 0:
                    failed.append(f"{name} ({proc.returncode})")
                else:
                    os.replace(tmp, so)
            build_log = "\n".join(logs)
            if failed:
                raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                                   f"{build_log}")
            build_seconds = time.perf_counter() - t0
        libs = {name: ctypes.CDLL(so) for name, (_, so) in jobs.items()}
        _bind(libs)
        _libs = libs
        return libs


# -- the user plans' libraries (kernel 1i) ------------------------------------

_plan_lock = threading.Lock()  # the user plans' own (load() may run beside)
_plan_libs: dict = {}   # build key -> ctypes.CDLL, loaded in this process
_plan_jobs: dict = {}   # build key -> _PlanJob, started and not yet loaded
# build key -> {"label", "seconds", "log"} of each plan this process built:
# the wall time from its nvcc's start to its end, and nvcc's output (the
# ``-Xptxas -v`` register and spill report)
plan_builds: dict = {}


class _PlanJob:
    """One running ``nvcc``: a thread reads its output as it comes (a full
    pipe would stall the compiler) and notes when it ended."""

    def __init__(self, cmd, tmp, so, label):
        self.tmp, self.so, self.label = tmp, so, label
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.out, self.t1 = "", None
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        self.out, _ = self.proc.communicate()
        self.t1 = time.perf_counter()


def plan_key(source: str) -> str:
    """The build key of a user plan's generated source: a hash of it, every
    ``csrc/`` file and the flags."""
    h = _sources_hash()
    h.update(source.encode())
    return h.hexdigest()[:16]


def plan_path(key: str) -> str:
    return os.path.join(BUILD_DIR, f"libfused_plan_{key}.so")


def _write(path: str, text: str) -> None:
    """Write through a temporary file and a rename, so that a process that
    writes the same file at the same time never leaves it half written."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def start_plan_builds(sources: dict) -> None:
    """Start one ``nvcc`` for each ``{label: generated source}`` that is
    neither built nor building, all at once, and return without waiting:
    :func:`load_plan` waits for its own. Two processes that build the same
    plan at once each compile into a file of their own and rename it into
    place."""
    with _plan_lock:
        for label, source in sources.items():
            key = plan_key(source)
            so = plan_path(key)
            if key in _plan_libs or key in _plan_jobs or os.path.exists(so):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            cu = os.path.join(BUILD_DIR, f"fused_plan_{key}.cu")
            _write(cu, source)
            tmp = f"{so}.{os.getpid()}.tmp"
            _plan_jobs[key] = _PlanJob(_nvcc_cmd(cu, tmp), tmp, so, label)


def load_plan(source: str, label: str):
    """The loaded library of one user plan's generated source (``label``
    names the plan): built at first use, or waited for where
    :func:`start_plan_builds` started it, and loaded once per process.
    Raises, naming the plan, where ``nvcc`` fails."""
    key = plan_key(source)
    with _plan_lock:
        lib = _plan_libs.get(key)
        if lib is not None:
            return lib
    start_plan_builds({label: source})
    with _plan_lock:
        lib = _plan_libs.get(key)
        if lib is not None:
            return lib
        job = _plan_jobs.pop(key, None)
        if job is not None:
            job.reader.join()
            if job.proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({job.proc.returncode}) for "
                                   f"the user plan {job.label}:\n{job.out}")
            os.replace(job.tmp, job.so)
            plan_builds[key] = {"label": job.label,
                                "seconds": job.t1 - job.t0, "log": job.out}
        lib = ctypes.CDLL(plan_path(key))
        _bind_transport(lib)
        _plan_libs[key] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def stream_of(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
