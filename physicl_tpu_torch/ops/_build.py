"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into the git-ignored
``_build/`` directory next to this package, and loaded with ``ctypes``. All
sources compile at once (one ``nvcc`` process each, started together). A
library's name carries a hash of the sources, the shared headers and the
flags, so an edited source never loads a stale build. Nothing here runs at
import time: importing the package needs no ``nvcc`` and no card.

Every plan outside the main path's op-sequence form runs a library of its
form's own: the source ``ops/codegen.py`` generates for it, built with the
same flags by :func:`load_plan` (or started ahead by
:func:`start_plan_builds`) into ``_build/`` under a hash of that source,
every ``csrc/`` file and the flags, and loaded once per process. The main
libraries and the form libraries build through the same jobs: at most one
``nvcc`` per CPU core runs at a time, each into a temporary file renamed
into place. Deleting ``_build/`` clears every build.
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

# the kernel structs of csrc/plan.cuh, member for member: the grid
# pointers lead the plan and every other member is 4 bytes wide, so both
# sides lay them out alike (the binding checks the sizes agree)
ROT_STEPS = 27  # the azimuth bisection's rotation table, k = 0 .. 26
# the main library's Plan sizes (ops, crossing planes, fields, field
# constants): the op-sequence plans' 3 ops (csrc/fused_transport.cu,
# PHYSICL_PLAN_DIMS)
MAIN_PLAN_DIMS = (3, 1, 1, 1)
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
                ("fld", _ci * 2)]


class AxisStruct(ctypes.Structure):
    _fields_ = [("axis", _ci), ("L", _cf), ("col", _ci), ("ecol", _ci),
                ("ecap", _ci)]


class FieldStruct(ctypes.Structure):
    _fields_ = [("kind", _ci), ("interp", _ci), ("n", _ci * 3),
                ("org", _cf * 3), ("sp", _cf * 3), ("outside", _cf),
                ("axis", _ci), ("ctr", _cf * 3), ("off", _ci), ("len", _ci),
                ("shape", _ci)]


_plan_types: dict = {}


def plan_struct_type(dims):
    """The ctypes mirror of ``csrc/plan.cuh``'s ``PlanT`` with table sizes
    ``dims`` = (ops, crossing planes, fields, field constants), each at
    least 1 (one class per sizes; its ``dims`` attribute names them)."""
    dims = tuple(max(1, int(d)) for d in dims)
    cls = _plan_types.get(dims)
    if cls is None:
        n_ops, n_axes, n_fields, n_k = dims
        cls = type("PlanStruct", (ctypes.Structure,), {"_fields_": [
            ("grids", ctypes.c_void_p * n_fields),
            ("ops", OpStruct * n_ops), ("axes", AxisStruct * n_axes),
            ("fields", FieldStruct * n_fields), ("fk", _cf * n_k),
            ("n_ops", _ci), ("n_cols", _ci), ("n_fcols", _ci),
            ("const_norm", _ci), ("const_speed", _cf),
            ("n_stream", _ci), ("stream_every", _ci),
            ("stream_bf16", _ci), ("n_extras", _ci), ("otype_x", _ci),
            ("wb_mask", _ci),
            ("rot_sd", _cf * ROT_STEPS), ("rot_cd", _cf * ROT_STEPS),
            ("uwb_mask", _ci)], "dims": dims})
        _plan_types[dims] = cls
    return cls


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
    """The C interface of a fused_transport library (the main one or a
    form's), after checking its Plan against the ctypes mirror of its
    sizes; ``ft.plan_dims`` keeps the sizes."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ft.fused_transport_plan_dims.restype = ci
    ft.fused_transport_plan_dims.argtypes = [ctypes.POINTER(ci)]
    dims = (ci * 4)()
    size = ft.fused_transport_plan_dims(dims)
    ft.plan_dims = tuple(dims)
    mirror = ctypes.sizeof(plan_struct_type(ft.plan_dims))
    if size != mirror:
        raise RuntimeError(f"fused_transport's Plan {ft.plan_dims} is {size}"
                           f" B but the ctypes mirror is {mirror} B")
    ft.fused_transport_grid.restype = ci
    ft.fused_transport_grid.argtypes = [ll, ci, ci, ci, ci,
                                        ctypes.POINTER(ci)]
    ft.fused_transport_launch.restype = ci
    ft.fused_transport_launch.argtypes = [
        vp, vp, ll, vp, ci, vp, vp, ci, vp, ci, ctypes.c_uint, vp, vp, ci,
        ci, vp, vp, vp, vp, ci, ci, vp]


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


# -- the build jobs ------------------------------------------------------------

_job_lock = threading.Lock()
_jobs: dict = {}        # build key -> _Job, started and not yet finished
# at most one nvcc per CPU core at a time (one nvcc of a form library takes
# a core and ~1 GB); the others wait their turn in their own threads
_slots = threading.BoundedSemaphore(max(1, os.cpu_count() or 1))


class _Job:
    """One ``nvcc`` into ``so`` (through a temporary file of this process):
    a thread waits for a free slot, starts the compiler, reads its output as
    it comes (a full pipe would stall it) and notes when it started and
    ended."""

    def __init__(self, src, so, label):
        self.so, self.label = so, label
        self.tmp = f"{so}.{os.getpid()}.tmp"
        self.cmd = _nvcc_cmd(src, self.tmp)
        self.out, self.rc, self.t0, self.t1 = "", None, None, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        with _slots:
            self.t0 = time.perf_counter()
            try:
                proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                self.out, _ = proc.communicate()
                self.rc = proc.returncode
            except OSError as e:  # no nvcc
                self.out, self.rc = str(e), -1
            self.t1 = time.perf_counter()


def _start(key, src, so, label) -> None:
    """Start the job that builds ``so`` from ``src`` unless it is built or
    building (call with ``_job_lock`` held)."""
    if key in _jobs or os.path.exists(so):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    _jobs[key] = _Job(src, so, label)


def _finish(key):
    """Wait for the job ``key`` if this process started it, rename its
    output into place and return it (None: nothing was building). Raises,
    naming its label and quoting nvcc, where the build failed."""
    with _job_lock:
        job = _jobs.get(key)
    if job is None:
        return None
    job.thread.join()
    with _job_lock:
        if _jobs.get(key) is not job:  # another thread finished it
            return job
        del _jobs[key]
        if job.rc != 0:
            raise RuntimeError(f"nvcc failed ({job.rc}) for {job.label}:\n"
                               f"{job.out}")
        os.replace(job.tmp, job.so)
    return job


def load():
    """Build (once per source hash) and load every kernel library; returns
    ``{name: ctypes.CDLL}`` keyed by source file stem."""
    global _libs, build_seconds, build_log
    with _lock:
        if _libs is not None:
            return _libs
        common = _sources_hash()
        libs = {}
        with _job_lock:
            for src in _csrc(".cu"):
                name = os.path.splitext(os.path.basename(src))[0]
                h = common.copy()
                h.update(name.encode())
                so = os.path.join(BUILD_DIR,
                                  f"lib{name}_{h.hexdigest()[:12]}.so")
                libs[name] = so
                _start(("main", name), src, so, name)
        done = [job for job in (_finish(("main", name)) for name in libs)
                if job is not None]
        if done:
            build_seconds = (max(j.t1 for j in done)
                             - min(j.t0 for j in done))
            build_log = "\n".join(f"[{os.path.basename(j.label)}]\n{j.out}"
                                   for j in done)
        libs = {name: ctypes.CDLL(so) for name, so in libs.items()}
        _bind(libs)
        _libs = libs
        return libs


# -- the form libraries -------------------------------------------------------

_plan_lock = threading.Lock()
_plan_libs: dict = {}   # build key -> ctypes.CDLL, loaded in this process
# build key -> {"label", "seconds", "log"} of each form this process built:
# the wall time from its nvcc's start to its end, and nvcc's output (the
# ``-Xptxas -v`` register and spill report)
plan_builds: dict = {}


def plan_key(source: str) -> str:
    """The build key of a form's generated source: a hash of it, every
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
    """Start one ``nvcc`` job for each ``{label: generated source}`` that
    is neither built nor building and return without waiting (the jobs
    share the CPU cores, see :class:`_Job`): :func:`load_plan` waits for
    its own. Two processes that build the same form at once each compile
    into a file of their own and rename it into place."""
    with _job_lock:
        for label, source in sources.items():
            key = plan_key(source)
            so = plan_path(key)
            if key in _plan_libs or key in _jobs or os.path.exists(so):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            cu = os.path.join(BUILD_DIR, f"fused_plan_{key}.cu")
            _write(cu, source)
            _start(key, cu, so, label)


def load_plan(source: str, label: str):
    """The loaded library of one form's generated source (``label`` names
    the plan): built at first use, or waited for where
    :func:`start_plan_builds` started it, and loaded once per process.
    Raises, naming the plan and quoting ``nvcc``, where the build fails."""
    key = plan_key(source)
    with _plan_lock:
        lib = _plan_libs.get(key)
        if lib is not None:
            return lib
    start_plan_builds({label: source})
    job = _finish(key)
    with _plan_lock:
        lib = _plan_libs.get(key)
        if lib is not None:
            return lib
        if job is not None:
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
