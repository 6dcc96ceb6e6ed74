#!/usr/bin/env python3
"""Time the port's transport kernel from several checkouts, in turns, on one
GPU: ``python3 scripts/torch_kernel_ab.py [--dump DIR] [--skip A,B]
[--forms A,B] [--attribute A,B] OLD NEW NEW OLD`` (``--skip``: user plans of
``chip_smoke.USER_PLANS`` not to time, e.g. ``past-limits``, whose build
takes minutes in each turn; ``--forms``: also time these forms, each where
the checkout plans it: ``chip_smoke.py``'s group plans (``ops-libm`` ...
``ops-loops``, 2**20 x 256) and the ``lattice``, ``voxel-index`` and
``aperture`` paths' first chunks (10**7 x 1024), with their registers,
iteration-loop SASS and, for the forms ``--attribute`` names, that SASS
by generated source line, ``scripts/sass_loop.py:attribute``).

Each argument is the root of a checkout holding ``physicl_tpu_torch``. For
each, in the order given, a fresh process imports that checkout's package,
builds its kernels (``nvcc`` into a temporary directory) and times
``fused_transport`` on the main path's shape (10**7 photons padded to
10,010,624 slots, 1024 iterations, [kin, iso, sign] with the const-norm
path, as the checkout runs it: through the op-sequence instantiation where
it has one, ``ms_main``, and then also through its generic variant 0 or,
since the form libraries, its form's library, ``ms_main_generic``), on [kin, iso, sign] and [kin, del, iso, sign] at 2**20
slots x 256 iterations and on ``chip_smoke.py``'s geometry, rotation,
Lorentz, polarized and user-code (kernel 1i) plans at that shape (the
latter four only where the checkout has their ops; the user plans as their
providers hand them over) and on the Planck source path's first chunk
(2**24 slots x 1024), with CUDA events over 3 and 5 launches after one
warm-up launch. It reads each kernel instantiation's registers from
``ptxas -v`` (keyed by its template arguments, e.g. ``b0b1b0b0`` = no
fields, geometry/streams, no rotation family, no Lorentz push or extras; a
fifth bit, polarization; a sixth, the user programs; ``seq:kin-iso-sign``
an op-sequence instantiation), and counts the iteration loop's SASS
instructions of variant 0 (in the checkouts that have it) and 64 (``scripts/
sass_loop.py`` of this checkout; with ``--dump DIR`` their SASS goes to
``DIR/<turn>/``). Prints one JSON object per checkout;
run both versions in one call, in turns, so that the card and its power
limit are the same for both.
"""

import json
import os
import subprocess
import sys

_CHILD = r"""
import dataclasses, json, os, re, shutil, sys, tempfile
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])  # chip_smoke.py's plans
sys.path.append(os.path.join(sys.argv[2], "scripts"))
import chip_smoke as cs
import sass_loop
import physicl_tpu_torch as phys
import physicl_tpu_torch.light as light
from physicl_tpu_torch.ops import _build
from physicl_tpu_torch.ops import fused as F
from physicl_tpu_torch.ops import record as RC

if not hasattr(RC, "loop_phases"):
    # a checkout before the block phases: its loops run per lane, with no
    # ballot of their own (chip_smoke.form_ballots counts a phase's)
    RC.loop_phases = lambda prog: ()

C_LIGHT = 299792458.0
dev = torch.device("cuda:0")
# a fresh build directory, so that ptxas reports every instantiation
_build.BUILD_DIR = tempfile.mkdtemp(prefix="kernel_ab_")
_build.load()
funcs = sass_loop.functions(sass_loop.built_sass())
shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
SEQ = hasattr(F, "SEQ_VARIANTS")


def packed(C):
    rng = np.random.default_rng(2)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.normal(size=(3, C)) * 1e3
    d = rng.normal(size=(3, C))
    p[6:9] = d / np.linalg.norm(d, axis=0) * C_LIGHT
    p[12] = 1.0
    p[13] = 1.0
    p[14] = 1.0
    return torch.from_numpy(p).to(dev)


out = {"root": sys.argv[1], "registers": {}, "sass": {}}
names = {v: k for k, v in F.OP_CODES.items()}
entry = None
for line in _build.build_log.splitlines():
    m = re.search(r"entry function '(\S*fused_(?:transport|seq)_kernel\S*)'",
                  line)
    if m and "fused_seq_kernel" in m.group(1):
        entry = "seq:" + "-".join(names[int(c)] for c in
                                  re.findall(r"Li(\d+)E", m.group(1)))
    elif m:
        entry = "".join(re.findall(r"Lb([01])E", m.group(1)))
        entry = "".join("b" + b for b in entry)
    m = re.search(r"Used (\d+) registers", line)
    if m and entry is not None:
        out["registers"][entry] = int(m.group(1))
        entry = None
for v in (0, 64) if SEQ else (0,):
    try:  # variant 0 is in the checkouts before the form libraries only
        name, ins = sass_loop.function_for(funcs, v)
    except (KeyError, ValueError):
        continue
    if len(sys.argv) > 3:
        os.makedirs(sys.argv[3], exist_ok=True)
        with open(os.path.join(sys.argv[3], f"variant_{v}.sass"), "w") as f:
            f.writelines(f"{a:05x} {t}\n" for a, t in ins)
    out["sass"][v] = sass_loop.variant_summary(funcs, v)
    del out["sass"][v]["function"]


def time_plan(pk, res, sched, K, plan, reps):
    F.fused_transport(pk, res, sched, 7, K, plan)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        F.fused_transport(pk, res, sched, 7, K, plan)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


for C, K, reps in ((10_010_624, 1024, 3), (1 << 20, 256, 5)):
    plan = F.FusedPlan(ops=[F._Op("kin"),
                            F._Op("iso", coef=1e-6, c_val=C_LIGHT),
                            F._Op("sign", cols=(1, 2))],
                       n_rec_cols=5, chunk=K, const_norm_speed=C_LIGHT)
    pk = packed(C)
    res = torch.empty_like(pk)
    sched = torch.zeros((5, K), dtype=torch.float32, device=dev)
    sched[0] = 0.001
    out[f"ms_{C}x{K}"] = time_plan(pk, res, sched, K, plan, reps)
    if SEQ:
        out[f"ms_{C}x{K}_generic"] = time_plan(
            pk, res, sched, K, dataclasses.replace(plan, specialize=False),
            reps)
    if C < 10_000_000:  # the generic variant 0 in both checkouts
        four = F.FusedPlan(ops=[F._Op("kin"),
                                F._Op("del", coef=1e-7, c_val=C_LIGHT),
                                F._Op("iso", coef=1e-6, c_val=C_LIGHT),
                                F._Op("sign", cols=(1, 2))],
                           n_rec_cols=5, chunk=K, const_norm_speed=C_LIGHT)
        out["ms_kin-del-iso-sign"] = time_plan(pk, res, sched, K, four, reps)
    del pk, res
# the Planck source path's first chunk (2**24 x 1024, a generic plan)
a_E, b_E = cs.planck_window()
pk, sched, seed, k, plan, starts = cs.planck_chunk_inputs(
    phys, F, light.PlanckSampler(a_E, b_E, cs.T_SUN, bins=2000), dev)
res = torch.empty_like(pk)
F.fused_transport(pk, res, sched, seed, k, plan, emit_starts=starts)
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
start.record()
for _ in range(3):
    F.fused_transport(pk, res, sched, seed, k, plan, emit_starts=starts)
end.record()
torch.cuda.synchronize()
out["ms_planck-chunk-0"] = start.elapsed_time(end) / 3
del pk, res
L = 64 * C_LIGHT * 0.001
pk = torch.from_numpy(cs.geometry_packed(1 << 20, L, 12)).to(dev)
res = torch.empty_like(pk)
sched = torch.zeros((5, 256), dtype=torch.float32, device=dev)
sched[0] = 0.001
plans = dict(cs.geometry_plans(F, 256, L))
if "hg" in F.OP_CODES:
    plans.update(cs.scatter_plans(F, light, 256, L))
for name, plan in plans.items():
    F.fused_transport(pk, res, sched, 7, 256, plan)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        F.fused_transport(pk, res, sched, 7, 256, plan)
    end.record()
    torch.cuda.synchronize()
    out[f"ms_{name}"] = start.elapsed_time(end) / 5
if "lorentz" in F.OP_CODES:
    for i, (name, (plan, photons)) in enumerate(
            cs.lorentz_plans(F, 256).items()):
        pk, sched, starts = cs.lorentz_inputs(torch, plan, photons,
                                              1 << 20, 256, dev, 40 + i)
        res = torch.empty_like(pk)

        def launch():
            F.fused_transport(pk, res, sched, 7, 256, plan,
                              emit_starts=starts)
        launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            launch()
        end.record()
        torch.cuda.synchronize()
        out[f"ms_{name}"] = start.elapsed_time(end) / 5
if "pol" in F.OP_CODES:
    for i, (name, (plan, photons)) in enumerate(
            cs.pol_plans(F, light, 256).items()):
        pk, sched, starts = cs.pol_inputs(torch, plan, photons, 1 << 20, 256,
                                          dev, 60 + i)
        res = torch.empty_like(pk)

        def launch():
            F.fused_transport(pk, res, sched, 7, 256, plan,
                              emit_starts=starts)
        launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            launch()
        end.record()
        torch.cuda.synchronize()
        out[f"ms_{name}"] = start.elapsed_time(end) / 5
SKIP = set(filter(None, os.environ.get("KERNEL_AB_SKIP", "").split(",")))
if "custom" in F.OP_CODES:
    for case in cs.USER_PLANS:
        if case in SKIP:
            continue
        pk, sched, seed, k, plan, _ = cs.first_chunk_inputs(
            cs.user_plan_sim(phys, case, dev), F)
        res = torch.empty_like(pk)

        def launch():
            F.fused_transport(pk, res, sched, seed, k, plan)
        launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            launch()
        end.record()
        torch.cuda.synchronize()
        out[f"ms_{case}"] = start.elapsed_time(end) / 5
# the forms of --forms: chip_smoke.py's group plans (2**20 x 256) and the
# lattice, voxel-index and aperture paths' first chunks (10**7 x 1024),
# where this checkout plans them; their builds started together
FORMS = [c for c in os.environ.get("KERNEL_AB_FORMS", "").split(",") if c]
if FORMS:
    from physicl_tpu_torch.ops import codegen
    paths = {"lattice": lambda: cs.lattice_sim(phys, cs.LAT_N, dev)[0],
             "voxel-index": lambda: cs.voxel_sim(phys, cs.VOX_N, dev)[0],
             "aperture": lambda: cs.aperture_sim(phys, cs.AP_N, dev)[0]}
    plans = {}
    for case in FORMS:
        try:
            make = paths.get(case) or (lambda: cs.ops_plan_sim(phys, case,
                                                              dev))
            plans[case] = cs.planned(make())[1].plan
        except Exception as e:  # a form this checkout refuses
            out[f"ms_{case}"] = f"not planned: {type(e).__name__}: {e}"[:200]
    _build.start_plan_builds({c: codegen.form_source(p)
                              for c, p in plans.items()})
    for case in plans:
        make = paths.get(case) or (lambda: cs.ops_plan_sim(phys, case, dev))
        pk, sched, seed, k, plan, _ = cs.first_chunk_inputs(make(), F)
        res = torch.empty_like(pk)
        reps = 3 if case in paths else 5

        def launch():
            F.fused_transport(pk, res, sched, seed, k, plan)
        launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        out[f"ms_{case}"] = start.elapsed_time(end) / reps
        loop = cs.form_loop(F, plan)
        out[f"form_{case}"] = {"registers": cs.form_regs(plan),
                               "sass_per_iteration": loop["per_iteration"],
                               "classes": loop["classes"]}
        if case in os.environ.get("KERNEL_AB_ATTRIBUTE", "").split(","):
            src = os.path.join(_build.BUILD_DIR, f"attr_{case}.cu")
            with open(src, "w") as f:
                f.write(codegen.form_source(plan))
            try:
                out[f"form_{case}"]["sass_by_source"] = sass_loop.attribute(
                    src, cs.form_ballots(plan))
            except Exception as e:
                out[f"form_{case}"]["sass_by_source"] = (
                    f"{type(e).__name__}: {e}"[:300])
        del pk, res
print(json.dumps(out))
"""


def main(args):
    dump, env = None, dict(os.environ)
    if args[:1] == ["--dump"]:
        dump, args = args[1], args[2:]
    keys = {"--skip": "KERNEL_AB_SKIP", "--forms": "KERNEL_AB_FORMS",
            "--attribute": "KERNEL_AB_ATTRIBUTE"}
    while args[:1] and args[0] in keys:
        env[keys[args[0]]], args = args[1], args[2:]
    if not args:
        sys.exit(__doc__)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for turn, root in enumerate(args):
        extra = [os.path.join(dump, str(turn))] if dump else []
        res = subprocess.run([sys.executable, "-c", _CHILD, root, here,
                              *extra], capture_output=True, text=True,
                             env=env)
        if res.returncode:
            sys.exit(f"{root}: exit {res.returncode}\n{res.stderr}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main(sys.argv[1:])
