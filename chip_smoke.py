#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs torch with CUDA, ``nvcc`` and numpy; it never imports JAX.

Phases (any failure exits non-zero and prints no result line):

1. device: a CUDA device is required; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: builds ``physicl_tpu_torch/csrc/*.cu`` with ``nvcc`` (one process
   per source, all at once) and prints the seconds it took and the
   compiler's register report; the kernel 1i plans this script runs
   (``USER_PLANS``, the user and spectrum paths, the deep shield's band
   tallies) are planned on the CPU while it runs, and their generated
   libraries (``ops/codegen.py``) start building after it, one ``nvcc``
   each, while the phases before 29 run; the main library holds no
   instantiation with the user bit (its grid query refuses every such
   variant);
3. ``fused_transport`` vs twin: the kernel against its plain PyTorch twin on
   the card, at 2**20 slots and 256 iterations for the main-path plans
   ([kin, iso, sign] and [kin, del, iso, sign]) and the Planck-path plans
   ([emit(Planck, isotropic), kin, iso, del, cross(energy sums)] and
   [emit(constant, directed), kin, cross(weighted)]), then at the main
   path's own shape (10**7 photons, 1024 iterations, [kin, iso, sign]): int
   records exactly equal, float planes within rtol 1e-6 + atol 1e-6 *
   max|plane|, float records (rec_f) within rtol 1e-5 + atol 1e-6 * the
   column's largest value and bitwise equal between two kernel runs,
   in-place launch equal to out-of-place; times kernel and twin. At the
   main path's shape the plan runs the op-sequence instantiation (variant
   64, ``fused_seq_kernel``): first the exhaustive check of its reciprocal
   root (equal to ``1.0f / sqrtf`` on every float32 of [0.5, 2), and every
   draw pair's squared norm inside that range), then planes and int records
   bitwise equal to the twin and to the generic variant 0 on the same
   inputs; prints both instantiations' registers, the SASS instruction
   counts of their iteration loops (``scripts/sass_loop.py``), their times
   in turns, the bound (the work the function needs, ``SEQ_OPS``, with
   its terms) and each one's issue time (the loop's instructions
   per warp-iteration over 4 x 132 x 1.98e9 issue slots per second);
4. ``fused_transport`` vs twin on the Planck source path's first chunk: the
   plan, state, schedule, seed and emit starts that the path's own provider
   hands the kernel (2**24 slots, 1024 iterations, lambda**-4 isotropic
   scattering, two crossing planes with energy sums, emission stopping at
   capacity inside the chunk, record tiles above the 48 KB default shared
   memory), held as in phase 3; prints the grid of both record-tile sizes;
5. ``fused_transport`` vs twin on four media plans at 2**20 slots and 256
   iterations over 64**3 grids (trilinear voxel n(r) with implicit capture,
   roulette, deposition, the absorbing box and a weighted sign tally;
   nearest voxel with analog absorption and deposition; layered r and z;
   C-expression n(r) with exp/pow/fmin and an A(E) expression): int records
   equal, planes bitwise (so torch's CUDA exp and pow agree with the
   kernel's expf and powf), rec_f as in phase 3;
6. ``fused_transport`` vs twin on the media path's first chunk, as its
   provider hands it over (10**7 photons, 1024 iterations, the 256**3
   continuous phantom, 104 KB record tiles), held as in phase 5; prints the
   grid;
6a. ``fused_transport`` vs twin on four stream and geometry plans at 2**20
    slots and 256 iterations in a box of 64 c dt: [kin, iso, reflect,
    trace(float32, scatter flags)], [kin, iso, periodic, trace(bfloat16,
    every 4)], [kin, iso, del, scross(weighted), sabsorb(inside),
    cross(energy capture)] and [kin, iso, sabsorb, scross]: int records
    equal, planes bitwise, stream buffers bitwise (NaN for NaN) with every
    row past ceil(k_act / stride) NaN, rec_f as in phase 3;
6b. the same on the escape path's and the cavity path's first chunks, as
    their providers hand them over (10**7 photons x 53 iterations with an
    energy-capture plane; 10**6 photons x 1024 iterations traced every 8th
    in bfloat16); prints the grid and the stream bytes;
7. ``planck_gen`` vs twin at 10**7 samples: bitwise equal; quantiles and
   mean against the analytic CDF of the window; times both;
8. main path: 10**7 photons through ``Simulation`` (the ``bench.py``
   steps, chunk_steps=1024, a t-exit of 5000 iterations): checks that the
   run went through the kernel's op-sequence instantiation for every
   chunk, the +x-share law 0.5 + 0.5 (1 - p)**k and
   finite state, and prints photon-steps/s over the dispatch loop after the
   first chunk, on the device's clock, and over the whole run from
   ``start()``, set-up included;
9. absorption: plain ``ScatterDeleteStep`` with an extinction exit at
   2**20 photons, through the [kin, del, sign] op-sequence instantiation
   (variant 65) for every chunk: the alive count follows N (1 - p)**k
   within 5 binomial sigma and the run ends; at the default
   ``auto_shrink`` (the capacities before and after printed; the arena
   empties inside the first chunk, so it keeps its capacity);
10. Planck source path: 10**7 initial photons from ``sample_device`` and
    ``generate_photon_state(device="cuda")`` in a 2**24-slot arena, a
    ``PhotonEmitterStep(8192, E=PlanckSampler, isotropic=True)``,
    wavelength-dependent isotropic scattering, plain absorption and
    plane-crossing energy tallies at +-L, 4096 iterations in chunks of
    1024: emission stops at capacity in chunk 0 and recycling fires before
    chunk 1; the alive count of the last chunk within 3% of N* = 8192
    (1-p)/p, the alive spectrum within 5% of the Planck density, tallies
    finite and bitwise equal in a second run with the same seed; prints the
    rates, the set-up time, the device idle share between the first and
    the last kernel (recycling included, from a torch.profiler trace that
    must hold the kernels) and the peak memory;
11. exact Beer-Lambert: the media path's beam and phantom under implicit
    capture alone for 1020 iterations (every photon inside the coverage):
    4096 photons' weights equal the host's float64 product of 1 - p over
    their samples (positions replayed in float32 as the kernel moves them)
    within 2 K 2**-24, and deposits plus the in-flight sum of w E equal
    N E within (2 K + the records' longest summation chain) 2**-24;
12. media path: 10**7 photons through ``Simulation`` (scattering and
    implicit-capture absorption sharing the phantom, roulette, deposition,
    the absorbing box, a weighted far-face tally with energy sums; 2048
    iterations in chunks of 1024), run twice: tallies finite, weights in
    (0, 1] and above the roulette floor, bitwise equal in the second run;
    prints the rates, set-up (the grid upload included), peak memory, the
    device idle share (profiled second run) and the kernel's time per
    chunk against its bound;
12a. escape path (path A): 10**7 photons from r = 0 with Planck energies
     (``sample_device``), isotropic scattering (A n c dt = 0.05),
     absorption (p = 1e-3), a plane at x = R/2 capturing energies in list
     mode, the shell tally and the escape sphere at R = 32 c dt, 1024
     iterations in ~20 chunks cut by the 2 GB record budget, run twice (the
     second profiled): every iteration's energy list is as long as its
     count, the listed spectrum within 5% of the Planck density, lists and
     tallies bitwise equal in the second run; prints the rates, set-up,
     peak memory and idle share; then the photon balance at 2**20 photons
     without absorption, traced on the card, at R = 32 c dt and off the
     c dt lattice: N0 = alive + escapes, and the shell crossings equal the
     escapes but for landings at the seam (r**2 within 64 ulp of R**2),
     which it counts and prints with the exact landings;
12b. cavity path (path B): 10**6 photons in a reflecting box of 64 c dt,
     isotropic scattering with pcoll = 0.3, a bfloat16 trace every 8th
     iteration with a 1 GiB device hold, 2048 iterations in two chunks,
     run twice (the second profiled): const-norm off (a reflection precedes
     scattering), chunk 0 spilled to host, ``as_arrays`` (256, 3, C) with
     the t row every 8th ``sim.ts``, every traced position inside the box,
     |v| = c within 1e-6, the last row's x, y, z histograms (16 bins on
     the bfloat16 grid) flat within 5 binomial sigma on the inner bins and
     within 5% at the walls (a folded photon's shorter |dr| lowers its
     collision probability there); prints the rates, peak memory and idle
     share; then at
     10**5 photons x 256 iterations the bfloat16 stride-8 trace equals the
     float32 unstrided trace's every 8th row rounded to nearest even;
13. card against CPU: small ``Simulation``s on the card and on the CPU,
    where they run the plain twins: an absorption and scattering run
    (2**16 photons, a t-exit right after the second 64-iteration chunk),
    an emitter run with Planck energies, plane tallies and recycling
    (chunk_steps=32, a 16384-slot arena), and a media run (2**16 photons,
    a 32**3 trilinear phantom for scattering, a layered field for
    implicit-capture absorption with roulette): equal ``sim.ts``, int
    records, spawn marks and recycling events, float records and final
    states within the tolerances above; and two 2**16-photon runs with
    every new step (a reflecting box with absorption, two energy-capture
    planes, a weighted shell tally and a traced path with scatter flags; a
    periodic box with a central absorber, a shell count and a bfloat16
    trace every 4th iteration): equal ``sim.ts``, tallies, energy lists and
    traces;
14. ``fused_transport`` vs twin on the rotation family and the del
    variants (``scatter_plans``) at 2**20 slots and 256 iterations: HG (g
    = 0.9), Rayleigh with lambda**-4, a Mie table (x = 5, 64 knots), cold
    Compton with sigma_KN and the heating tally, thermal Compton (theta_e =
    0.01), the refractive plane with and without match_speed, the
    exponential transform with a weighted sign, fluorescence with an A(E)
    expression and deposition: int records equal, planes bitwise, rec_f as
    in phase 3, each timed against its bound;
15. physics gates on the kernel, one iteration of 2**20 photons that all
    collide: HG <cos> = g and Rayleigh <cos^2> = 2/5 within 5 sigma, a
    256-knot Mie table's <cos> within 1e-3 of its g (2**22 photons), the
    Klein-Nishina E'/E histogram's chi2/dof < 2 against the analytic bin
    integrals at alpha 0.1, 1 (Kahn) and 10 (Koblinger); thermal Compton
    at an unsaturated p = 0.3 drifts <E'/E> - 1 within 0.005 of 4 theta_e
    at alpha = 1e-9 and within 0.008 of 0 at alpha = 4 theta_e; a glass ->
    air plane reflects within 5 sigma of Fresnel at 30 degrees and all at
    60 (total internal reflection);
16. ``fused_transport`` vs twin on the first chunks of the gamma path
    (10**7 x 1024), the glass slab (10**7 x 80), thermal Comptonization,
    the exponential transform and fluorescence (10**7 x 1024 each), held
    as in phase 5 (the gamma and thermal chunks over their first 256
    iterations, ``TWIN_ITERS``), each timed against its bound;
17. gamma path (benchmarks/run_all.py compton_kn_1e7 with the heating
    tally): 10**7 photons, 5 chunks of 1024 through ``Simulation``, run
    twice (the second profiled): deposits plus the photons' energies equal
    N E0 within 1e-5, |v| = c, deposits bitwise in the second run; prints
    the rates, peak memory and idle share;
18. glass-slab path (examples/make_fresnel_nb.py sweep 1): 10**7 photons at
    45 degrees on a 1.6 c dt slab of n = 1.5, 80 iterations: every photon
    transmitted or reflected, the transmission within 5 sigma of (1 - R) /
    (1 + R);
19. thermal Comptonization and the exponential transform at 10**7 photons
    x 1024 iterations and Fe K-alpha fluorescence at 10**7 x 40 through
    ``Simulation``: |v| = c and no photon lost; the weighted transmission
    within 5 sigma of Beer-Lambert at every iteration; the source and line
    populations within 5 sigma of the two-rate closed form and the energy
    budget within 1e-4;
20. the tissue plan (kin -> fresnel -> hg -> implicit capture -> absorbing
    box -> weighted plane tally) on the card and on the CPU twin at 2**16
    photons: equal ``sim.ts`` and alive counts, live slots bitwise;
21. ``fused_transport`` vs twin on the six Lorentz and mixed plans
    (``lorentz_plans``) at 2**20 slots and 256 iterations over a growing-dt
    schedule: a species-wide q/m in E and B, per-particle q/m in B, the
    photon population's q/m = 0 no-op, the push before the update, a mixed
    population's push, scattering and absorption, and the same with an
    emitter and per-particle q/m: int records equal, every plane (the
    extras included) bitwise, each timed against its bound;
22. the same on the first chunks of the ExB path (10**7 x 256), the mixed
    path (10**7 x 256) and the record-tile plan (10**7 x 984: the chunk
    clamped by its 3 int + 7 float record columns);
23. ExB path (benchmarks/run_all.py lorentz_boris_exb_1e7): 10**7
    particles from ``generate_particle_state(device=...)``, E = (4, 0, 0),
    B = (0, 0, 200), q/m = 1, chunks of 256 through ``Simulation`` for the
    788 iterations nearest a whole number of gyro-turns, run twice (the
    second profiled): every lane bitwise equal to the others, v within
    rtol 1e-4 of a float64 host Boris run, the mean velocity within 1% of
    the ExB drift (0, -0.02, 0); then the mixed path (run_all.py
    mixed_species_1e7: 5 x 10**6 photons and 5 x 10**6 charges, 1024
    iterations): photon survivors within 5 sigma of (1 - p)**k with the
    24-bit uniform's p, no charge dies, charge speeds 1 within rtol 3e-5,
    photon speeds c; both print the rates, peak memory and idle share;
24. the record-tile plan at 10**7 photons through ``Simulation``: two
    chunks of 984 (the clamp in ``explain_plan()``), finite tallies with
    crossings in both chunks;
25. ``fused_transport`` vs twin on the eleven polarized plans
    (``pol_plans``) at 2**20 slots and 256 iterations: Rayleigh (packed
    angles), with lambda**-4, with a C-expression n(r); Compton, with
    sigma_KN and the heating tally; the Stokes tally alone (weighted, local
    Q and U) and after Rayleigh; a directed polarized source and an
    isotropic circular one over stale Stokes and frame rows; fluorescence
    on a polarized population with no polarized op; a mixed photon/charged
    population: int records equal, every plane (the Stokes and frame rows
    included) bitwise, rec_f as in phase 3; each printed with its time,
    bound, grid and the instantiation's registers;
26. the exact laws of one forced scatter (pcoll = 2) on the kernel at
    2**20 photons: Rayleigh on unpolarized light Q' = (c**2 - 1) / (1 +
    c**2), U' = V' = 0, on circular light V' = 2c / (1 + c**2); Compton at
    alpha = 0.5 Q' = -s**2 / (kappa - s**2) and E' = E / eta; everywhere p
    <= 1, |e1| = 1 and e1 . d = 0 within 1e-5;
27. ``fused_transport`` vs twin on the polarized and polarimetry paths'
    first chunks (10**7 photons x 1024, as their providers hand them over;
    both over their first 256 iterations):
    int records equal, planes bitwise, rec_f as in phase 3, the Stokes and
    frame rows leading the extras; timed against the bound;
28. polarized path (benchmarks/run_all.py polarized_rayleigh_1e7): 10**7
    photons from ``polarized_photon_state(device=...)``, Rayleigh with A = n
    = 1e-3, 2048 iterations in chunks of 1024, run twice (the second
    profiled): p <= 1, frames unit and orthogonal to v within 1e-5, |v| = c
    within 1e-6, finite planes; then the polarimetry path
    (examples/make_polarimetry_nb.py at 10**7 photons: linear polarization,
    forced polarized Compton at alpha = 0.5 with the heating tally, the
    Stokes tally, one chunk of 1024): the mean purity falls from the
    source's 1 over the first three rows, then rises (the recoil lowers
    alpha) and stays below 0.97 over the first 12 rows, the last tally row equals the final planes' means within 1e-5,
    deposits + sum E = N E0 within the records' summation-chain bound; both
    print the rates, peak memory and idle share;
29. ``fused_transport`` vs twin on the ten kernel 1i plans
    (``USER_PLANS``) at 2**20 slots and 256 iterations, as their providers
    hand them over: an ElementwiseStep with t, dt and exp, one with draws
    (one drawn and never used) and an alive clear, one reading and writing
    a 1-row and a 3-row extras plane; a ReduceMeasureStep with the alive
    count; MeshTallyStep on x with path lengths and on r weighted under
    implicit capture; a KernelStep reading otype on a photon/charge
    population; run_all.py's weighted tally under implicit capture and
    roulette; the fluorescence example's A(E) as a torch callable (a
    recorded field program); an ElementwiseStep past the interpreter's old
    limits (60 live values, 70 draws, over 1200 instructions): int records
    equal, every plane (the written-back extras included) bitwise, rec_f as
    in phase 3, each user plan on its own generated library, each timed
    against its bound and printed with its build seconds, its
    instantiation's registers and spills, its blocks per SM and its
    programs' SASS instructions per photon-iteration
    (``scripts/sass_loop.py --user``);
30. the same on the user path's first chunk (10**7 x 1024, over its first
    256 iterations: kin, iso, a
    KernelStep drag, an ElementwiseStep decay with a draw, t, dt and a
    written-back dose, the moments tally) and the spectrum path's (10**7
    x 62: thermal Compton and two 56-bin spectra, the chunk clamped by the
    record tiles of its 117 columns), each printed with its generated
    library's build seconds, registers and spills, blocks per SM and SASS
    instructions per photon-iteration, as in phase 29;
31. user path (run_all.py kernelstep_drag_fused_1e7 with engine.py's
    decay and moments examples): 10**7 photons, 2048 iterations in chunks
    of 1024, run twice (the second profiled): every alive |v| between c
    (1 - 1e-7)**K and c, E_total = n and the alive photons' dose 0 in
    every row, the written-back dose plane summing to N0 - n, the
    survivors within 5 sigma of prod(1 - p_k); then the spectrum path
    (run_all.py spectrum_56bin_x2_thermal_1e7, cut to 240 iterations):
    the bins and capture bins sum to n in every row, the last row equals a
    histogram of the final planes, the energy bins sum to the alive
    energy within rtol 1e-5; both print the rates, peak memory and idle
    share;
32. the generic step tier on the main path: the ``bench.py`` workload with
    ``fuse="off"`` (10**7 photons, 1024 iterations in chunks of 256): no
    ``fused_transport`` launch (the counts, and torch.profiler over a
    second run of 512 iterations), the state and its generator on the
    card, ``sim.ts`` byte-identical to the host's float32 Kahan replay,
    the +x counts of both tiers within 5 sigma of the scatter law (each
    iteration's n_alive p scatters leave +x half the time) and of each
    other; prints photon-steps/s over the dispatch loop on the device's
    clock beside the fused main path's, and the device idle share;
33. the fallback through a refusal: the same workload for 256
    iterations with a dt function that reads ``n_objects``
    (``dt-fn-not-t-only`` in ``explain_plan()``, one RuntimeWarning), run
    to its end on the generic tier with the same law and clock;
34. the deep shield (examples/make_split_nb.py's slab: 36 steps deep,
    p_abs 0.06, p_scat 0.16, importance doubling every 4 steps, 300
    iterations) at 5 x 10**5 photons in a 2**24-slot arena, in three
    modes: analog (fused), ``split`` (``ImportanceSplitStep(at="step")``,
    the generic tier) and ``split_chunk`` (``at="chunk"``, fused in chunks
    of 8, a boundary op between them): each split pass conserves the
    weight of the particles it may split (float64 sums of the float32
    weights) within 1e-6, the split modes take the tier they should
    (``split_chunk`` launches ``fused_transport``, ``split`` never), a
    per-band tally (8 photon groups, copies keep their band) equals the
    plane tally and gives each mode's batch sigma, and the three
    transmissions agree within 5 combined sigma; prints each mode's wall
    time and rate;
35. ``fused_transport`` vs twin on the recorded plans at 2**20 slots and
    256 iterations, as their providers hand them over: the magnetic
    mirror's callable B (three recorded component programs), callable E
    and B with a constant component, two recorded inverse CDFs
    (``cos_theta_icdf``: test_phase.py's linear law and an HG law with an
    integer power and divides), and a plan past every old table limit (17
    ops, 9 fields, 71 expression instructions): int records equal, planes
    bitwise; each timed against its bound (a recorded program counted by
    its own operations, ``prog_ops``; the inverse CDF per collision);
36. the magnetic mirror (examples/make_lorentz_nb.py:98-112 at 10**7
    particles, 1000 iterations in chunks of 256) through ``Simulation``:
    its first chunk (10,010,624 x 256, as its provider hands it over)
    against the twin, int records equal and planes bitwise, timed against
    its bound; the fused tier, every particle alive, the relative |v|
    drift within the constant pure-B gate (3e-5); the rate;
37. the callable phase function: one forced scatter at 2**20 gives <mu> =
    a/3 within 5 sigma and |v| = c within 3e-5, 8 iterations at 2**20 give
    the beam's mean <v_x> / c = (1 - p (1 - a/3))**8 within 5 sigma, then
    bench.py's workload
    with ``ScatterPhaseFunctionStep(cos_theta_icdf=linear, a = 0.6)`` for
    the isotropic scatter (10**7 photons, 1024 iterations in chunks of
    256): its first chunk against the twin as in 36, then fused through
    ``Simulation``, the +x share of every iteration's tally within 5
    binomial sigma of its law (after m scatters the direction density is
    1/2 + (3/2) (a/3)**m mu, so the share is (1-p)**k + (1 - (1-p)**k) / 2
    + (3/4) ((1 - p (1 - a/3))**k - (1-p)**k)), and |v| = c; the rate;
38. the generic scatter family: run_all.py's Compton (:439-450) and
    polarized Rayleigh (:391-413, linearly polarized, with a Stokes tally)
    workloads at 10**7 photons x 64 iterations under ``fuse="off"`` and
    fused: the final direction, energy and Stokes means and the Compton
    tally's per-iteration counts within 5 combined sigma, the mean purity
    within 1e-6 of 1 on both tiers (a pure state stays pure); prints both
    tiers' rates;
39. shrink: an extinction run of 10**7 photons at the default
    ``auto_shrink`` (absorption 0.002 per iteration, chunks of 256): a
    shrink, survivors within 5 sigma of (1 - p)**k; the first chunk
    launched at each shrunk capacity (its inputs copied as the provider
    hands them over) against the twin, int records equal and planes
    bitwise; prints each chunk's capacity, device time and alive
    photon-steps/s (phase 9, the absorption run, empties its arena inside
    its first chunk and so never shrinks: it checks that). The rate
    paths of the earlier phases keep ``auto_shrink=False`` so that their
    chunk times stay comparable with the earlier PRs' (a shrink launches
    the later chunks over fewer lanes);
40. mid-run injection on the main path: bench.py's 10**7 photons (chunks
    of 1024, 10 chunks, the default pipeline depth of 4), with 2**20
    photons (E = 2, built on the card) injected from the measure step's
    collect after chunk 2: they land where the pipeline next drains, the
    capacity grows from 10,010,624 to 11,059,200 slots, every launch is
    variant 64, the run stays fused, every injected photon is alive and
    the records' alive count steps at that boundary; prints the kernel's
    time per chunk before and after (CUDA events around each launch), the
    boundary's cost (``_apply_injections`` synchronized, and the device
    idle between the kernels around it), photon-steps/s over the dispatch
    loop; the first chunk at the grown capacity against the twin over its
    first 256 iterations (bitwise), timed against its bound;
41. checkpoint: the injected run's state saved (``np.savez_compressed``,
    the JAX package's format) and restored onto the card: the seconds and
    bytes; the restored planes equal the saved ones, and the restored run
    takes the fused tier and continues ``sim.ts``;
42. mid-run edits on the card against the CPU twin at 2**16 photons (256
    iterations in chunks of 32): a deterministic injection, a
    ``remove_obj`` (``auto_shrink=False``), a non-photon injection that
    falls back to the generic tier (a draw-free plan), and a run restored
    from a checkpoint: ``sim.ts``, records and final planes bitwise equal;
43. ``spatial_sort`` on the media path: 10**7 photons at uniform positions
    and isotropic directions in the 256**3 phantom (the locality-free
    case), 1024 iterations in chunks of 256, sorted every dispatch and
    not, twice each: the kernel's time per chunk, the sort's time (CUDA
    events) and the rates; the alive counts within 5 sigma;
44. ``KernelProgram.run`` on the card against the CPU on 2**20 photons (no
    draws): equal outputs and tracked indices;
45. profiling: ``profiling.trace`` around a fused run at 2**20 photons
    writes a Chrome trace that names ``fused_seq_kernel``;
    ``ChunkTimerStep`` rows of a generic run.
46. mesh: bench.py's 10**7 photons over an 8-shard mesh on one card
    (``make_mesh(8, devices=["cuda:0"])``, 5 chunks of 1024): every launch
    variant 64 over one shard's planes, 8 launches a chunk, the +x law;
    the chunk time of the 8 launches together against the unsharded
    chunk of the same run shape (CUDA events around each launch); shard
    0's first chunk against the twin over its first 256 iterations
    (bitwise); then, each on the card and on the CPU twin, bitwise
    (``sim.ts``, records, final planes): the main plan at 2**16 photons,
    emitter windows straddling shard edges, recycling with absorption on
    a full arena, a mid-run injection that grows the arena by a shard
    unit, and a checkpoint written on 8 shards resumed on 4 (equal to the
    uninterrupted 8-shard run). On a host with several cards, the same
    five runs with the card side's shards spread over every card, and the
    main path's chunk time unsharded, over 8 shards on the first card,
    over 8 shards on every card and over one shard a card (on the first
    card's clock). ``python3 chip_smoke.py --mesh-cards`` runs the build
    and these several-card runs alone;
47. differentiable runs (``functional.scan_steps`` on torch autograd):
    implicit-capture transmission and dT/dA at 2**20 photons x 100
    iterations against the closed forms (rtol 1e-4), a checkpointed
    gradient with roulette draws bitwise equal to the plain one, the
    card's gradient at 2**16 within 1e-5 of the CPU's, then 10**7 photons
    x 100 plain and with ``remat``: forward and backward times and
    ``torch.cuda.max_memory_allocated``, the gradients bitwise equal;
48. the main path across processes: the script starts itself twice
    (``--mp-worker card RANK 2 PORT DIR``) as one gloo process group
    sharing the card, 4 shards a process (8 in all, as phase 46), each
    loading the kernels this process built: every launch variant 64, both
    processes' sign records bitwise equal to phase 46's, each process's
    chunk time on its own clock beside phase 46's, the host time of the
    records' all-gather a chunk and of the guard's row a boundary; then,
    across the two processes, each on the card and on the CPU twin at
    2**16 photons, bitwise: an injection under the divergence guard
    (issued from a measure step's collect on both, applied at one
    boundary), recycling on a full arena, the E-list of tagged energies
    (complete, in slot order) and a shard-local trace; last, global shard
    4's first chunk (launched by rank 1) against the twin, bitwise. With
    ``--mesh-cards`` on a host with several cards, the main path also
    runs with one process a card over NCCL (``--mp-worker cards``), one
    and two shards a card.

The line before the last two is a JSON object describing each kernel on
each path: ``fused_transport`` once each for the gamma, glass, thermal,
stretch and fluorescence paths, the ExB (``lorentz``), mixed and
record-tile paths, the polarized and polarimetry paths, the user and
spectrum paths (their ``replaces`` the user ops of kernel 1i), the mirror
and callable-phase paths, the main path after a mid-run injection (its
first chunk at the grown capacity), the main path over an 8-shard mesh
(its ``ms`` the chunk of the 8 launches together), the main path across
2 processes (``main-mp``: its ``ms`` the mean of the processes' chunks
on their own clocks, its launches both processes'), the main path,
the Planck source path, the media path, the escape path and the cavity path, each
with its path's launch count and the times and bound at that path's own
shape and plan (the main path's entry also names its instantiation, and
its bound counts the work the function needs, ``SEQ_OPS``) (the bound
counts the fields' corner reads and the stream stores as lane operations
at the load/store issue rate, and the stream buffer's bytes), and
``planck_gen`` for the Planck source path. The last line is ``{"ok": true,
"device": {...}}``.
"""

import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

C_LIGHT = 299792458.0
K_B = 1.380649e-23
T_SUN = 5778.0
RTOL = 1e-6
RTOL_F = 1e-5
# the gamma, thermal, polarized, polarimetry and user paths' first chunks
# are held against the twin over their first 256 iterations (each twin took
# 20-100 s over the whole chunk)
TWIN_ITERS = 256

# H100 SXM published peaks: 3.35 TB/s device memory; per SM and clock 128
# float32 and 64 int32 lane-operations, 132 SMs at 1.98 GHz
PEAK_BYTES = 3.35e12
PEAK_F32 = 128 * 132 * 1.98e9
PEAK_I32 = 64 * 132 * 1.98e9
# load/store issue: 32 lanes per SM and clock (four 8-lane units)
PEAK_LD = 32 * 132 * 1.98e9
# instruction issue: four warp-instructions per SM and clock
PEAK_ISSUE = 4 * 132 * 1.98e9

# Lane-operations per photon-iteration, counted from the kernel source
# (csrc/fused_transport.cu) for the const-norm path: (float32, int32). The
# loop row is the per-iteration bookkeeping (dt load, hash seed, record row
# pointers, the op dispatch); "count" is one warp vote + popcount + lane-0
# test; a hash is 3 + 12 integer operations; a correctly rounded sqrt or
# divide is counted as 8 float operations.
OPS_PER_ITER = {
    # dt load, hash seed, record row pointers, op dispatch
    "loop": (0, 15),
    # plans with stream planes: the sample test and the stride counter
    "stream_row": (0, 3),
    "kin": (6, 0),
    # norm 2, uniform 2, pair 4, test 1, four fast sines 43, nx/ny 2,
    # |n|^2 5, sqrt 8, divide 8, scale 4, selects and dv 9
    "iso": (88, 2 * 16 + 3),
    # lambda**-4 weighting: base, square, fourth power, product; flag test
    "iso_wl": (88 + 4, 2 * 16 + 4),
    # norm 2, uniform 2, test 1, alive select 1; hash 16, alive logic 3
    "del": (6, 16 + 3),
    "sign": (3, 4 * 3 + 3),
    "col0": (0, 3),
    # every slot: start load and address 3, 64-bit window test 6, draw
    # indices 2, alive update 3; alive select 1
    "emit": (1, 14),
    # per plane: lo 1, two-sided test 4; axis selects 4, logic 3, a count
    # 3, plane loop 2
    "plane": (5, 4 + 3 + 3 + 2),
    # per energy sum: select 1, shuffle tree 5 adds; 5 shuffles, column
    # test 1, lane test 2
    "esum": (6, 5 + 1 + 2),
    # a weighted plane: the plane test, then a weight sum ("esum") where
    # the count was
    "plane_w": (5 + 6, 4 + 3 + 2 + 5 + 1 + 2),
    # weighted sign: three selects and weight sums where the counts were
    "sign_w": (3 + 3 * 6, 3 * 8 + 3),
    # absorbing box: six compares, alive logic 6, alive select 1
    "absorb": (7, 6),
    # implicit capture on top of "del" without its draw: clip 2, w update 2
    # and select 1; the draw's hash and test come off
    "capture": (5 - 3, 3 - 16),
    # deposition tally: product(s) 2 and select 1, a weight sum ("esum")
    "dep": (3 + 6, 8),
    # roulette: uniform 2, two compares, product 1, selects 2; hash 16,
    # logic 4
    "roulette": (6, 16 + 4),
    # a field read through a pointer: the kind and index tests
    "field": (0, 4),
    # voxel, trilinear: 3 subtractions, 3 divides (8 each), 6 inside
    # compares, 3 floors, 6 clamps, 3 converts, 3 clips (2 each), 3 (1 - t),
    # 8 x (3 products and 1 sum), the outside select; index 4, 8 corner
    # addresses 3 each, 3 converts back
    "voxel_tri": (3 + 24 + 6 + 3 + 6 + 3 + 6 + 3 + 32 + 1, 4 + 24 + 3),
    # voxel, nearest: 3 subtractions, 3 divides, 6 compares, 3 rints, 6
    # clamps, 3 converts, the select; index 4
    "voxel_near": (3 + 24 + 6 + 3 + 6 + 3 + 1, 4),
    # layered: the radius (3 subtractions, 5 for the square sum, sqrt 8) or
    # an axis select, two range tests and NaN test 3; bisection per level
    # 1 compare, 4 integer operations
    "layered_r": (16 + 3, 4),
    "layered_axis": (3, 4),
    "layered_level": (1, 4),
    # one postfix instruction: the load, dispatch and stack move (integer),
    # the operation (float; a transcendental counted as 20)
    "ins": (1, 8),
    "ins_transcendental": (20, 8),
    # periodic, per axis: L, r - lo, mod_floor (a divide 8, floor, product,
    # difference, two compare-selects of 2) and lo + y
    "periodic": (3 * 17, 0),
    # reflect, per axis: L, 2L, r - lo, mod_floor 14, the odd test, 2L - y,
    # a select, lo + y, two wall tests, the r select, negate and select v,
    # dr 2; logic 2
    "reflect": (3 * 28, 3 * 2),
    # sabsorb: 3 differences, 3 squares and 2 sums, R*R, the test; logic 3,
    # alive select 1
    "sabsorb": (10, 4),
    # scross: 6 differences, two squared norms of 5, R*R, 4 compares;
    # logic 4 and a count 3 (a weighted shell: a weight sum, "esum")
    "scross": (21, 4 + 3),
    # one sampled trace: per position plane a select, an address (2) and
    # the sample test; scatter flags: 3 compares, 2 ors, a select, address
    "trace": (3, 1 + 3 * 2),
    "trace_dv": (3 + 1, 2 + 2),
    # a captured energy per iteration: the select, the test and address
    "ecap": (1, 3),
    # hg/rayl/phase per photon-iteration: norm 2, coef 1, uniform 2, the
    # test 1, three dv zeros 3; two hashes, the pair's index, kind and flag
    # tests 5
    "rot": (9, 2 * 16 + 5),
    # one collision's rotation (scatter_rotate): the pair's halves 4, sin
    # theta 11, two fast sines 18, their norm 19 and scaling 2, the unit
    # direction 25, the basis and the rotated direction 30, its
    # renormalisation 22, v and dv 9; the halves' shifts and masks 6
    "rotate": (140, 6),
    # the polar angle: HG 2 products and sums, two divides 16, s*s, the
    # difference, the clip 2 (isotropic-limit test 2); Rayleigh w 2, the
    # root's argument 2, sqrt 8, log2 20, exp2 16, 1/a 8, the difference
    # and the clip 3 (the bit work 12); the phase table x 1, floor 1,
    # the segment's start and slope 3, + 0 1, the clip 2 (the index and
    # the cap 4, two loads)
    "hg_cos": (22, 2),
    "rayl_cos": (59, 12),
    "phase_cos": (8, 4),
    # compton per photon-iteration: alpha 1, u 2, the test 1, three dv
    # zeros 3; a hash, the azimuth and the tries' indices 8
    "compton": (7, 16 + 8),
    # sigma_KN / sigma_T (the branch alpha >= 0.5): log2 20, the closed form
    # 16 products and sums and four divides 32; the branch tests 4
    "kn_xsec": (68, 8),
    # one Kahn try: r1 2, the pair's halves 4, eta_a 2, 1 / eta_a 8, the
    # branch and its acceptance 8; two hashes, the indices 4
    "kn_try": (24, 2 * 16 + 4),
    # cold recoil: E / eta 8, the tally's w (E - E') 2 and its weight sum
    "recoil": (10 + 6, 8),
    # thermal per photon-iteration: u 2, the unit direction 25, two radii
    # (max, log2 20, product, sqrt 8) 60, three fast sines 27, beta 6, its
    # square 5, |beta| 8, the scale's divide 8 and min 2, beta and b2
    # scaled 5, gamma 12, beta.n 5, the flux 2, the boost 32, its
    # renormalisation 22, E1 and alpha1 2, the test 1; five hashes, the
    # indices and the halves 12
    "thermal": (246, 5 * 16 + 12),
    # a thermal collision after its tries: E / eta 8, sin theta 11, two
    # fast sines 18, the rotation 30, two renormalisations 44, beta.n' 5,
    # the boost back 32, E' 1, v and dv 9, the tally 2 (and its weight
    # sum)
    "thermal_scatter": (160 + 6, 8),
    # fresnel per photon-iteration: u 2, the axis selects 4, the side tests
    # 3; a hash, the logic 4
    "fresnel": (9, 16 + 6),
    # one crossing: the unit direction 25, cos_i and sin2_t 6, sqrt 8, the
    # Fresnel coefficients 10 and two divides 16, R 4, the reflection test
    # 1, s 10, the refracted direction and its norm 25, the outgoing speed
    # 8, the remainder 4, positions, dr and v 18; the axis selects 6
    "fresnel_cross": (135, 6),
    # the exponential transform on top of "del": mu 5 and its divide 8, two
    # clips 4, the bias 3, the cap 2, the ratio 10, the weight update 2
    "stretch": (34, 4),
    # fluorescence on top of "del": y 2, the three tests 3; two hashes,
    # the logic 6
    "fluor": (5, 2 * 16 + 6),
    # one re-emission: cos and sin theta 13, two fast sines 18, the norm 19
    # and scaling 4, v, dv and E 10; the pair's halves 6
    "fluor_emit": (64, 6),
    # lorentz per particle-iteration, the push's own work only: h 1, three v
    # selects and three dv 6; the dt's address in its schedule row 1 (the
    # push is `alive` on a plan without an otype plane; with one, "gate")
    "lorentz": (7, 1),
    # a constant E: three products, two kicks of three sums
    "lorentz_E": (9, 0),
    # a constant B: t 3, v' 12, s = 2 / (1 + |t|^2) 6 and its divide 8, v+
    # 15
    "lorentz_B": (44, 0),
    # per-particle q/m: 0.5 dt (the plane is read once per slot, before
    # the iterations)
    "lorentz_qm": (1, 0),
    # the otype gate of a photon op or a push on a mixed plan: one logic
    # operation
    "gate": (0, 1),
    # pol per slot-iteration: pcoll 1, u 2, the test 1, dv zeros 3; the
    # frame re-orthonormalized for every slot: the unit direction 25, the
    # projection 11, n2 5, its test 1, 1 / sqrt 17, e1 3; a hash, the
    # pair's index, the kind and flag tests 5
    "pol": (7 + 62, 16 + 5),
    # polc per slot-iteration: alpha 1, pcoll 1, u 2, the test 1, dv zeros
    # 3, the frame 62; a hash, the azimuth's and the tries' indices 8
    "polc": (8 + 62, 16 + 8),
    # one polarized turn (pol_scatter after the angle): r_t 11 and a, b 2,
    # the bisection's steps (midpoint 1, rotation 6, fv 4, test 1, selects
    # 3; the first step rotates nothing), its end (rotation 6, phi 1,
    # renormalisation 22 and 2, the half-angle root 12 and divide 8, signs
    # 3), the Fano rows and clips 30, the purity clamp 27, sin theta 10,
    # e2, a, d' and e1' 36, their renormalisations 45, v, dv and the frame
    # 9; the branch and selects 6
    "pol_turn_17": (13 + 17 * 15 - 6 + 54 + 57 + 100, 6),
    "pol_turn_26": (13 + 26 * 15 - 6 + 54 + 57 + 100, 6),
    # a Compton turn's kappa (a divide and a sum) and its azimuth uniform
    "polc_kappa": (9 + 2, 16),
    # polmeas: the weight 2, p 13, three weight sums ("esum") and the
    # products 3; the count (if any) is "col0"
    "polmeas": (2 + 13 + 3 * 7, 3 * 8),
    "polmeas_qu": (2 * 7, 2 * 8),
    # a polarized source's rows per emitted photon: six stores' selects
    "emit_pol": (6, 1),
}
# lane-loads per field read (gathers, at the SM's load/store issue rate)
LOADS_PER_FIELD = {"voxel_tri": 8, "voxel_near": 1, "layered": 2}
# The main path's plans ([kin, iso, sign], [kin, del, sign] in their
# op-sequence form, whichever instantiation runs them), counted from the
# work the function needs and nothing of a kernel's bookkeeping (loop,
# dispatch, record addresses, dt and key loads): per photon-iteration
# (FMA pipe, ALU pipe, issue only, MUFU) lane-operations. The FMA pipe takes
# the float32 adds and products and the integer multiplies, at PEAK_F32;
# the ALU pipe the shifts, logic, integer and float compares, at PEAK_I32;
# an add or select that either pipe (or a predicate) can do, and a warp
# vote, count only in the issue total, as do the hardware reciprocal roots
# (MUFU, which also have a pipe of their own). Every
# rounding of the reference is one operation, and the products by a power
# of two (2 tu, the four 4 y of the fast sines, 0.5 y) are exact and not
# counted.
SEQ_OPS = {
    # dr = v dt 3, r + dr 3
    "kin": (6, 0, 0, 0),
    # the 16-bit uniforms 2, the wraps 3 and the + 0.5s 2, four fast sines
    # of 5 (1 - |y|, the product, 0.225 |p|, + 0.775, p times it), n 7
    # (n0, n1, |n|^2 5), 1 / sqrt correctly rounded 5 (a residual and a
    # correction for each rounding) and its 2 MUFU, the scale 4, dv 3; two
    # draws' murmur3 multiplies 4 | two finalizers of 5 shifts and 4
    # logic ops, the uniforms' bit builds 3, the collision compare against
    # the pre-shifted threshold 1, the wraps' compares 3 | the draws' key +
    # slot adds 2, a uniform's shift 1, the three dv selects 3
    "iso": (2 + 3 + 2 + 20 + 7 + 5 + 4 + 3 + 4, 18 + 3 + 1 + 3, 2 + 1 + 3,
            2),
    # one draw: multiplies 2 | finalizer 9, the compare 1, alive && !hit 1
    # | the key add 1, the alive plane's select 1
    "del": (2, 9 + 1 + 1, 1 + 1, 0),
    # the three alive && v > 0 compares | their four ballots (one warp
    # instruction each: 4 per photon-iteration of issue)
    "sign": (0, 3, 4, 0),
}
# planck_gen per sample: uniform 2, range test 2, half 2, x (sub + divide)
# 9, Horner 14, clip 4; hash 16, slot term 5, loop 3, five bisection steps
# of 5 and the table address 5
OPS_PER_SAMPLE = (33, 16 + 5 + 3 + 25 + 5)
# once per emitted photon, on top of "emit": a sampled energy (the inverse
# CDF above, its hash and bisection, the scale test) and an isotropic
# direction (iso's pair, sines, norm, sqrt, divide and scale; one hash)
OPS_PER_EMITTED = {"E": (33 + 1, 16 + 25 + 5), "dir": (74, 16)}

PLANCK_CAP = 1 << 24     # arena slots of the Planck source path
PLANCK_N0 = 10_000_000   # initial photons
PLANCK_EMIT = 8192       # photons emitted per iteration
PLANCK_ITERS = 4096      # 4 chunks of 1024 (the half-arena clamp)
PLANCK_DT = 1e-3
PLANCK_P_DEL = 2e-3      # absorption per iteration
SPECTRUM_TOL = 0.05      # alive spectrum against the Planck density

MEDIA_N = 10_000_000     # photons of the media path (bench.py's width)
MEDIA_NV = 256           # voxels per side of the CT-scale phantom
MEDIA_DT = 1e-3
MEDIA_ITERS = 2048       # two chunks of 1024
MEDIA_AS = 0.01          # A_s c dt: ~10-30 scatters across the phantom
MEDIA_AA = 0.002         # A_a c dt: transmitted weight ~e^-2 at n = 1
MEDIA_ROULETTE = (0.1, 0.5)
BL_ITERS = 1020          # Beer-Lambert: every photon stays in the coverage
BL_CHECKED = 4096        # photons whose weight the host recomputes

ESC_N = 10_000_000       # escape path: photons (bench.py's width)
ESC_DT = 1e-3
ESC_R = 32               # escape radius in c dt
ESC_ITERS = 1024
ESC_SCATTER = 0.05       # A n c dt of the isotropic scattering
ESC_ABSORB = 1e-3        # absorption per iteration
ESC_CLOSURE_N = 1 << 20  # the photon-balance run (no absorption, traced)
CAV_N = 1_000_000        # cavity path: photons
CAV_DT = 1e-3
CAV_L = 64               # cavity side in c dt
CAV_ITERS = 2048         # two chunks of 1024
CAV_PCOLL = 0.3          # isotropic scattering per iteration
CAV_EVERY = 8            # trace stride
CAV_HOLD = 1 << 30       # device_hold_bytes: chunk 0 spills


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def bound_terms(n_bytes, f32_ops, i32_ops, loads=0):
    """The least time in ms each resource alone would take: the bytes over
    the memory rate, and the float32, int32 and load/store instructions
    over their issue rates (separate pipes, so each type bounds alone)."""
    return {"bytes": n_bytes / PEAK_BYTES * 1e3,
            "f32": f32_ops / PEAK_F32 * 1e3,
            "i32": i32_ops / PEAK_I32 * 1e3,
            "loads": loads / PEAK_LD * 1e3}


def bound(n_bytes, f32_ops, i32_ops, loads=0):
    """Least time in ms the card could take: the largest of bound_terms,
    and whether bytes or operations set it."""
    terms = bound_terms(n_bytes, f32_ops, i32_ops, loads)
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations"


def field_cost(fn):
    """(per-iteration (float32, int32) counts, lane-loads) of one read of a
    field callable, from its spec."""
    spec = fn.spec
    if spec["kind"] == "voxel":
        key = "voxel_tri" if spec["interp"] == "trilinear" else "voxel_near"
        return [OPS_PER_ITER["field"], OPS_PER_ITER[key]], \
            LOADS_PER_FIELD[key]
    if spec["kind"] == "layered":
        levels = int(np.ceil(np.log2(max(2, len(spec["values"])))))
        per = [OPS_PER_ITER["field"],
               OPS_PER_ITER["layered_r" if spec["axis"] == 3
                            else "layered_axis"]]
        per += [OPS_PER_ITER["layered_level"]] * levels
        return per, LOADS_PER_FIELD["layered"] + levels
    per = [OPS_PER_ITER["field"]]
    for code, _ in spec["prog"]:
        per.append(OPS_PER_ITER["ins_transcendental" if code in (7, 13, 14,
                                                                 15, 16, 17,
                                                                 18)
                                else "ins"])
    return per, 0


def user_cost(op):
    """(float32, int32) lane-operations per slot-iteration of the work a
    recorded user program asks for (kernel 1i): each operation the user's
    callable wrote (a correctly rounded divide, root or reciprocal 8, a
    transcendental 20, an integer power its products), a draw's hash and
    scale, an alive clear, a record sum ("esum"), the t and dt loads and a
    reduce's count; loads, constants and stores are register moves, and
    the interpreter's fetch and dispatch are not the user's work."""
    from physicl_tpu_torch.ops import record as RC

    f32, i32 = 0, 2
    for code, _, _, _, y, _ in op.prog.ins:
        if code in (RC.U_LD, RC.U_T, RC.U_DT, RC.U_CONST, RC.U_ST):
            continue
        if code == RC.U_UNIF:
            f32, i32 = f32 + 2, i32 + 16
        elif code in (RC.U_SQRT, RC.U_DIV, RC.U_RECIP):
            f32 += 8
        elif code in (RC.U_EXP, RC.U_LOG, RC.U_LOG10, RC.U_SIN, RC.U_COS,
                      RC.U_TAN, RC.U_POW):
            f32 += 20
        elif code == RC.U_IPOW:
            e = abs(int(y))
            f32 += max(e.bit_length() + bin(e).count("1") - 2, 0) \
                + (8 if y < 0 else 0)
        elif code == RC.U_ALIVE:
            f32, i32 = f32 + 1, i32 + 1
        elif code == RC.U_ACC:
            f32, i32 = f32 + OPS_PER_ITER["esum"][0], \
                i32 + OPS_PER_ITER["esum"][1]
        else:
            f32 += 1
    if op.kind == "reduce" and op.cols[0] >= 0:
        i32 += OPS_PER_ITER["col0"][1]
    return f32, i32


def main_form(plan):
    """The op sequence of ``plan`` if it has the main path's form (its
    op-sequence instantiation runs it unless it asks for the generic one or
    its chunk is too long), else None."""
    return dataclasses.replace(plan, specialize=True, chunk=1).kernel_seq


def seq_terms(plan, slots, k_act):
    """bound_terms() of a main-form plan from SEQ_OPS, and the time to
    issue its operations at one instruction each (``issue``) and the MUFU
    pipe's time (16 lanes per SM and clock)."""
    per = [sum(SEQ_OPS[k][j] for k in main_form(plan)) * slots * k_act
           for j in range(4)]
    terms = bound_terms(2 * 60 * slots, per[0], per[1])
    terms["issue"] = sum(per) / 32 / PEAK_ISSUE * 1e3
    terms["mufu"] = per[3] / (PEAK_F32 / 8) * 1e3
    return terms


def transport_bound(plan, slots, k_act, starts, events=None):
    """bound() of one fused_transport launch of ``plan``."""
    return bound(*transport_counts(plan, slots, k_act, starts, events))


def expected_events(plan, packed, alive_steps, dt, cross_p=0.0):
    """{op index: expected events} of one launch whose alive photon-
    iterations number ``alive_steps`` (the sum of its column-0 counts): the
    rotation family's collisions, a compton op's Kahn tries (one per
    collision: later tries are not counted), fluorescent re-emissions, at
    the collision probability of the initial live photons' energies; an
    interface's crossings at ``cross_p`` per photon-iteration. The kernel
    does this work only for these events, so the bound counts them from
    the run's data instead of for every slot."""
    import torch

    from physicl_tpu_torch import light

    live = packed[13] > 0
    E = packed[12][live].float()
    events = {}
    for i, op in enumerate(plan.ops):
        if op.kind == "fresnel":
            events[i] = cross_p * alive_steps
            continue
        if op.kind not in ("hg", "rayl", "phase", "compton", "pol",
                           "polc") and not op.fluor:
            continue
        p = torch.full_like(E, op.coef * C_LIGHT * dt)
        if op.wl_base is not None:
            p = p * (E * op.wl_base) ** 4
        if op.kind in ("compton", "polc") and op.kn_xsec:
            p = p * light._kn_sigma_ratio(E * op.inv_mec2, fast=True)
        p = p.clamp(0.0, 1.0)
        if op.fluor:
            p = p * op.fluor[0] * (E >= op.fluor[2])
        events[i] = float(p.double().mean()) * alive_steps
    return events


def transport_counts(plan, slots, k_act, starts, events=None):
    """(bytes, float32 ops, int32 ops, lane-loads) of one fused_transport
    launch of ``plan``: 2 x 60 B per slot, 4 B per extras plane per slot
    read (and per emitted slot written), each voxel grid read once and the
    stream buffer written once; the lane-operations of its ops over slots x
    k_act slot-iterations plus the once-per-photon work of the emissions
    ``starts`` schedules and of the sampled trace iterations, and the work
    per collision, crossing or re-emission for the ``events``
    (``expected_events``) of the rotation family; the fields' gathers, the
    phase tables' reads and the stream stores as lane-loads at the
    load/store issue rate."""
    if main_form(plan) is not None:
        fma, alu = (sum(SEQ_OPS[k][j] for k in main_form(plan)) * slots
                    * k_act for j in (0, 1))
        return 2 * 60 * slots, fma, alu, 0
    per, once = [OPS_PER_ITER["loop"], OPS_PER_ITER["col0"]], []
    events = events or {}
    if plan.n_stream:
        per.append(OPS_PER_ITER["stream_row"])
    loads, grids = 0, {}
    stream_elems = plan.n_stream_rows * plan.n_stream * slots
    sampled = -(-k_act // plan.stream_every)  # trace rows with data
    event_loads = 0.0  # the phase tables' reads, per collision
    n_emitted = 0
    for i, op in enumerate(plan.ops):
        n_ev = events.get(i, 0.0)
        for fn in (op.n_fn, op.a_fn):
            if fn is not None:
                cost, ld = field_cost(fn)
                per += cost
                loads += ld
                if fn.spec["kind"] == "voxel":
                    grids[id(fn.spec)] = 4 * fn.spec["flat"].size
        if op.kind == "iso":
            per.append(OPS_PER_ITER["iso" if op.wl_base is None
                                    else "iso_wl"])
        elif op.kind == "del":
            per.append(OPS_PER_ITER["del"])
            if op.stretch:
                per.append(OPS_PER_ITER["stretch"])
            if op.fluor:
                per.append(OPS_PER_ITER["fluor"])
                once.append((OPS_PER_ITER["fluor_emit"], n_ev))
            if op.implicit_capture:
                per.append(OPS_PER_ITER["capture"])
                if op.roulette:
                    per.append(OPS_PER_ITER["roulette"])
            if op.cols:
                per.append(OPS_PER_ITER["dep"])
        elif op.kind == "sign":
            per.append(OPS_PER_ITER["sign_w" if op.weighted else "sign"])
        elif op.kind == "emit":
            per.append(OPS_PER_ITER["emit"])
            row = starts[op.emit_row, :k_act]
            n = int((row > -(2 ** 30)).sum()) * op.emit_n
            n_emitted += n
            if op.emit_table is not None:
                once.append((OPS_PER_EMITTED["E"], n))
            if op.emit_v is None:
                once.append((OPS_PER_EMITTED["dir"], n))
            if op.emit_stokes:
                once.append((OPS_PER_ITER["emit_pol"], n))
        elif op.kind == "cross":
            if op.cols[0] >= 0:
                per.append(OPS_PER_ITER["col0"])
            for axis in op.axes:
                per.append(OPS_PER_ITER["plane_w" if op.weighted
                                        else "plane"])
                if axis[3] >= 0:
                    per.append(OPS_PER_ITER["esum"])
                if len(axis) > 4 and axis[4] >= 0:
                    per.append(OPS_PER_ITER["ecap"])
        elif op.kind == "scross":
            per.append(OPS_PER_ITER["scross"])
            if op.cols[0] >= 0:
                per.append(OPS_PER_ITER["col0"])
            if op.weighted:
                per.append(OPS_PER_ITER["esum"])
        elif op.kind == "trace":
            once.append((OPS_PER_ITER["trace"], slots * sampled))
            if op.stream_scat:
                once.append((OPS_PER_ITER["trace_dv"], slots * sampled))
        elif op.kind in ("hg", "rayl", "phase"):
            per.append(OPS_PER_ITER["rot"])
            if op.wl_base is not None:
                per.append((4, 1))
            once.append((OPS_PER_ITER["rotate"], n_ev))
            if op.kind == "phase" and op.phase_fn is not None:
                # a recorded inverse CDF: its program and the clip (2)
                once.append(((prog_ops(op.phase_fn.spec) + 2, 0), n_ev))
            else:
                once.append((OPS_PER_ITER[f"{op.kind}_cos"], n_ev))
                if op.kind == "phase":
                    event_loads += 2 * n_ev
        elif op.kind == "compton":
            thermal = op.theta_e > 0
            per.append(OPS_PER_ITER["thermal" if thermal else "compton"])
            if op.kn_xsec:
                per.append(OPS_PER_ITER["kn_xsec"])
            once += [(OPS_PER_ITER["kn_try"], n_ev),
                     (OPS_PER_ITER["thermal_scatter" if thermal
                                   else "rotate"], n_ev)]
            if not thermal:
                once.append((OPS_PER_ITER["recoil"], n_ev))
        elif op.kind == "fresnel":
            per.append(OPS_PER_ITER["fresnel"])
            once.append((OPS_PER_ITER["fresnel_cross"], n_ev))
        elif op.kind == "pol":
            per.append(OPS_PER_ITER["pol"])
            if op.wl_base is not None:
                per.append((4, 1))
            once += [(OPS_PER_ITER["pol_turn_17"], n_ev),
                     (OPS_PER_ITER["rayl_cos"], n_ev), ((0, 16 + 4), n_ev)]
        elif op.kind == "polc":
            per.append(OPS_PER_ITER["polc"])
            if op.kn_xsec:
                per.append(OPS_PER_ITER["kn_xsec"])
            once += [(OPS_PER_ITER["kn_try"], n_ev),
                     (OPS_PER_ITER["pol_turn_26"], n_ev),
                     (OPS_PER_ITER["polc_kappa"], n_ev),
                     (OPS_PER_ITER["recoil"], n_ev)]
        elif op.kind == "polmeas":
            per.append(OPS_PER_ITER["polmeas"])
            if op.cols[0] >= 0:
                per.append(OPS_PER_ITER["col0"])
            if op.local_qu:
                per.append(OPS_PER_ITER["polmeas_qu"])
        elif op.kind in ("custom", "reduce", "kstate"):
            per.append(user_cost(op))
        elif op.kind == "lorentz":
            per.append(OPS_PER_ITER["lorentz"])
            if op.e_const or op.e_fns:
                per.append(OPS_PER_ITER["lorentz_E"])
            if op.b_const or op.b_fns:
                per.append(OPS_PER_ITER["lorentz_B"])
            # recorded fields: each component's program at every push
            per += [(prog_ops(fn.spec), 0) for fn in op.e_fns + op.b_fns]
            if op.qm_plane >= 0:
                per.append(OPS_PER_ITER["lorentz_qm"])
        else:
            per.append(OPS_PER_ITER[op.kind])
        if "otype" in plan.extras and op.kind in (
                "del", "iso", "hg", "rayl", "phase", "compton", "fresnel",
                "lorentz", "pol", "polc"):
            per.append(OPS_PER_ITER["gate"])
    ops = [sum(p[j] for p in per) * slots * k_act
           + sum(o[j] * n for o, n in once) for j in (0, 1)]
    elem = 2 if plan.stream_dtype == "bfloat16" else 4
    # the extras planes: read once, written for the emitted slots, and the
    # written-back planes for every slot
    n_wb = sum(1 for name in plan.extras
               if name.split(":")[0] in plan.extras_writeback)
    extras = 4 * (len(plan.extras) * (slots + n_emitted) + n_wb * slots)
    return (2 * 60 * slots + extras + sum(grids.values())
            + elem * stream_elems,
            *ops, loads * slots * k_act + event_loads + stream_elems)


def random_packed(C, seed):
    """Seeded (15, C) packed photon state: random positions, directions at
    speed c, energies, ~90% alive."""
    rng = np.random.default_rng(seed)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.normal(size=(3, C)) * 1e3
    d = rng.normal(size=(3, C))
    p[6:9] = d / np.linalg.norm(d, axis=0) * C_LIGHT
    p[12] = rng.uniform(0.5, 2.0, C)
    p[13] = rng.uniform(size=C) < 0.9
    p[14] = 1.0
    return p


def cuda_ms(fn, reps, torch):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close_planes(got, ref):
    diff = (got - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True)
    return (bool((diff <= RTOL * ref.abs() + RTOL * scale).all()),
            float(diff.max()))


def close_rec_f(got, ref):
    scale = ref.abs().amax(dim=0, keepdim=True)
    return bool(((got - ref).abs() <= RTOL_F * ref.abs()
                 + RTOL * scale).all())


def planck_window():
    kT = K_B * T_SUN
    return 0.1 * kT, 12 * kT


def planck_mean(edges, cdf):
    """Mean energy of the binned Planck CDF (bin masses at bin centres)."""
    mass = np.diff(np.concatenate([[0.0], cdf]))
    return float(np.sum(mass * 0.5 * (edges[1:] + edges[:-1])))


def density_check(E, light, tol):
    """The pattern of tests/test_emitter.py:203-216: histogram density of
    ``E`` against the analytic Planck density on bins above 10% of the
    peak; returns the worst relative deviation."""
    a, b = planck_window()
    hist, edges = np.histogram(E, bins=40, range=(a, b), density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    analytic = np.array([float(light.planck_distribution(x, T_SUN).value())
                         for x in centers])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    analytic /= trapezoid(analytic, centers)
    mask = analytic > 0.10 * analytic.max()
    rel = float((np.abs(hist[mask] - analytic[mask]) / analytic[mask]).max())
    check(rel < tol, f"spectrum off the Planck density: {rel:.4f} >= {tol}")
    return rel


def main():
    import torch

    phase("device")
    check(torch.cuda.is_available(), "no CUDA device "
          "(torch.cuda.is_available() is false)")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import physicl_tpu_torch as phys
    from physicl_tpu_torch.ops import _build
    from physicl_tpu_torch.ops import fused as F
    from physicl_tpu_torch.ops import planck as P
    from physicl_tpu_torch.state import pad_capacity

    light = phys.light
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}", flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    phase("build")
    t0 = time.perf_counter()
    # the user plans are planned on the CPU while the main libraries
    # build; their libraries then build while the phases before 29 run
    main_build = threading.Thread(target=_build.load)
    main_build.start()
    sources = user_plan_sources(phys)
    t_plan = time.perf_counter() - t0
    main_build.join()
    _build.load()  # raises here if the build failed
    _build.start_plan_builds(sources)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, all sources at "
          f"once: {_build.build_seconds or 0:.2f} s; {len(sources)} user "
          f"plans planned on the CPU meanwhile in {t_plan:.2f} s, their "
          "libraries started now, one nvcc each)")
    for line in _build.build_log.splitlines():
        if line.startswith("[") or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    # every instantiation's registers and spills (variant bits: fields 1,
    # geometry and streams 2, rotation family 4, extras 8, polarization 16,
    # both only with extras); kernel 1i's user bit 32 is in no variant of
    # the main library: each user plan has its own (phase 29)
    for v in range(66):
        if (v < 16 or v & 8 or v >= 64) and not v & 32:
            print(f"  fused_transport variant {v}: {kernel_regs(v)}")
    refused = [v for v in range(32, 64)
               if _build.load()["fused_transport"].fused_transport_grid(
                   1024, 1, 1, 0, v, ctypes.byref(ctypes.c_int(0))) != 0]
    check(len(refused) == 32, "the main library holds a user variant: "
          f"{sorted(set(range(32, 64)) - set(refused))}")
    print("main library: every variant with the user bit refused (kernel 1i "
          "runs each plan's generated library)", flush=True)

    seed = 123_456_789
    # largest plane difference from the twin, per path
    err = {"main": 0.0, "planck": 0.0, "planck_gen": 0.0, "media": 0.0,
           "escape": 0.0, "cavity": 0.0, "rot": 0.0, "gamma": 0.0,
           "glass": 0.0, "thermal": 0.0, "stretch": 0.0, "fluor": 0.0,
           "lorentz": 0.0, "mixed": 0.0, "record-tile": 0.0, "pol": 0.0,
           "polarized": 0.0, "polarimetry": 0.0, "user": 0.0,
           "spectrum": 0.0, "mirror": 0.0, "recorded-E-B": 0.0,
           "phase-icdf": 0.0, "phase-icdf-hg": 0.0, "wide": 0.0,
           "shrink": 0.0, "main-injected": 0.0, "main-mesh": 0.0,
           "main-mp": 0.0}
    a_E, b_E = planck_window()
    sampler = light.PlanckSampler(a_E, b_E, T_SUN, bins=2000)

    def compare(name, packed, sched, K, plan, starts=None, path="main",
                seed=seed, need_bitwise=False):
        """Kernel (out of place, in place, and once more for rec_f) against
        the twin on the same inputs; returns the twin's time in ms.
        ``need_bitwise``: the planes must equal the twin's bitwise."""
        out = torch.empty_like(packed)
        rec, rec_f, *stream = F.fused_transport(packed, out, sched, seed, K,
                                                plan, emit_starts=starts)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ref, ref_rec, ref_f, *ref_stream = F.fused_chunk_reference(
            packed, sched, seed, K, plan, starts)
        end.record()
        torch.cuda.synchronize()
        if plan.n_stream:
            # bit for bit, NaN for NaN; rows past ceil(K / stride) all NaN
            filled = -(-K // plan.stream_every)
            check(stream_equal(stream[0], ref_stream[0]),
                  f"{name}: stream planes differ from the twin's")
            check(bool(torch.isnan(stream[0][filled:].float()).all()),
                  f"{name}: stream rows past the last sample are not NaN")
            del ref_stream
        check(torch.equal(rec, ref_rec), f"{name}: int records differ "
              f"(first rows kernel {rec[:2, :5].tolist()} twin "
              f"{ref_rec[:2, :5].tolist()})")
        ok, e = close_planes(out, ref)
        err[path] = max(err[path], e)
        check(ok, f"{name}: planes out of tolerance (max abs err {e})")
        check(close_rec_f(rec_f, ref_f), f"{name}: float records out of "
              f"tolerance (kernel {rec_f[:2, :4].tolist()} twin "
              f"{ref_f[:2, :4].tolist()})")
        bitwise = torch.equal(out, ref)
        check(bitwise or not need_bitwise, f"{name}: planes not bitwise "
              "equal to the twin's")
        del ref
        inplace = packed.clone()
        rec2, rec_f2, *stream2 = F.fused_transport(
            inplace, inplace, sched, seed, K, plan, emit_starts=starts)
        torch.cuda.synchronize()
        check(torch.equal(inplace, out), f"{name}: in-place launch differs "
              "from out-of-place")
        check(torch.equal(rec2, rec) and torch.equal(rec_f2, rec_f)
              and (not plan.n_stream or stream_equal(stream[0], stream2[0])),
              f"{name}: records differ between two kernel runs")
        del stream, stream2
        print(f"{name}: int records equal, planes bitwise={bitwise}"
              + (", stream planes bitwise (NaN for NaN)" if plan.n_stream
                 else "") + f", max "
              f"abs err {e}, rec_f within rtol {RTOL_F} and reproducible "
              f"(max |rec_f| {float(rec_f.abs().max()):.6g}), alive after "
              f"{K} iterations {int(ref_rec[K - 1, 0])}", flush=True)
        return start.elapsed_time(end)

    def plan_of(kinds, chunk):
        ops = [F._Op(k, coef=1e-6, c_val=C_LIGHT) if k in ("iso", "del")
               else F._Op(k, cols=(1, 2)) if k == "sign" else F._Op(k)
               for k in kinds]
        return F.FusedPlan(ops=ops, n_rec_cols=5, chunk=chunk,
                           const_norm_speed=C_LIGHT)

    def emit_plans(chunk):
        L = 3e6
        planck = F.FusedPlan(ops=[
            F._Op("emit", emit_n=2048, c_val=C_LIGHT,
                  emit_table=P.icdf_table(sampler.data), emit_scale=1.0),
            F._Op("kin"),
            F._Op("iso", coef=1e-7, c_val=C_LIGHT),
            F._Op("del", coef=1e-8),
            F._Op("cross", cols=(1,), axes=((0, L, 2, 0), (0, -L, 3, 1)))],
            n_rec_cols=4, chunk=chunk, const_norm_speed=C_LIGHT,
            n_frec_cols=2)
        const = F.FusedPlan(ops=[
            F._Op("emit", emit_n=2048, emit_E=2.0,
                  emit_v=(C_LIGHT, 0.0, 0.0)),
            F._Op("kin"),
            F._Op("cross", cols=(-1,), weighted=True,
                  axes=((0, L, 0, 1), (1, L, 2, 3)))],
            n_rec_cols=1, chunk=chunk, n_frec_cols=4)
        return {"emit-planck-kin-iso-del-cross": planck,
                "emit-const-kin-cross-weighted": const}

    def emit_schedule(C, first, n, chunk):
        starts = torch.full((1, chunk), -(2 ** 30), dtype=torch.int32)
        fits = min(chunk, (C - first) // n)
        starts[0, :fits] = first + n * torch.arange(fits, dtype=torch.int32)
        return starts.to(dev)

    def dt_sched(chunk):
        sched = torch.zeros((5, chunk), dtype=torch.float32, device=dev)
        sched[0] = 0.001
        return sched

    times = {}
    phase("fused_transport vs twin (2**20 slots, 256 iterations)")
    C, K = 1 << 20, 256
    packed = torch.from_numpy(random_packed(C, 1)).to(dev)
    sched = dt_sched(K)
    plans = {"-".join(k): (plan_of(k, K), None)
             for k in (("kin", "iso", "sign"), ("kin", "del", "iso", "sign"))}
    free = torch.from_numpy(random_packed(C, 3)).to(dev)
    free[13, C // 2:] = 0.0  # half the arena free for the emitter
    starts = emit_schedule(C, C // 2, 2048, K)
    plans.update({n: (p, starts) for n, p in emit_plans(K).items()})
    for name, (plan, st) in plans.items():
        inp = free if st is not None else packed
        plain_ms = compare(name, inp, sched, K, plan, st,
                           "main" if st is None else "planck")
        out = torch.empty_like(inp)
        F.fused_transport(inp, out, sched, seed, K, plan, emit_starts=st)
        ms = cuda_ms(lambda: F.fused_transport(inp, out, sched, seed, K,
                                               plan, emit_starts=st),
                     5, torch)
        times[name] = ms
        print(f"{name} at 2**20 x {K}: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.3f} ms per chunk [{card}]", flush=True)
    del packed, free, out

    phase("fused_transport vs twin at the main path's shape (10**7 photons, "
          "1024 iterations)")
    N, chunk = 10_000_000, 1024
    main_plan = plan_of(("kin", "iso", "sign"), chunk)
    generic_plan = dataclasses.replace(main_plan, specialize=False)
    check(main_plan.kernel_variant == 64 and generic_plan.kernel_variant == 0,
          "the main plan does not select the op-sequence instantiation")
    near1 = F.rsqrt_near1_check(dev)
    check(near1["mismatches"] == 0 and near1["out_of_range"] == 0,
          f"the sequence kernel's reciprocal root: {near1}")
    print(f"rsqrt_rn_near1: equal to 1.0f / sqrtf on all 2**24 float32 of "
          f"[0.5, 2); |n|**2 of all 2**32 draw pairs in [{near1['n2_min']}, "
          f"{near1['n2_max']}]", flush=True)
    pk = torch.from_numpy(random_packed(pad_capacity(N), 2)).to(dev)
    sched_m = dt_sched(chunk)
    ft = {"plain_ms": compare("kin-iso-sign", pk, sched_m, chunk, main_plan,
                              need_bitwise=True)}
    # out of place, as the engine launches it
    outs = [torch.empty_like(pk) for _ in range(2)]
    recs = [F.fused_transport(pk, o, sched_m, seed, chunk, p)[0]
            for o, p in zip(outs, (main_plan, generic_plan))]
    torch.cuda.synchronize()
    check(torch.equal(*outs) and torch.equal(*recs), "the op-sequence "
          "instantiation differs from the generic variant 0")
    print("kin-iso-sign: variant 64 (op sequence) bitwise equal to variant 0 "
          "(generic) in planes and int records", flush=True)
    slots = pk.shape[1]
    turns = {64: [], 0: []}
    for p in (main_plan, generic_plan, generic_plan, main_plan):
        turns[p.kernel_variant].append(cuda_ms(
            lambda: F.fused_transport(pk, outs[0], sched_m, seed, chunk, p),
            3, torch))
    ft["ms"] = float(np.mean(turns[64]))
    ft["bound_ms"], ft["bound_by"] = transport_bound(main_plan, slots, chunk,
                                                     None)
    terms = seq_terms(main_plan, slots, chunk)
    print("kin-iso-sign bound from the work the function needs (SEQ_OPS, "
          "per photon-iteration: FMA pipe, ALU pipe, issue only, MUFU "
          f"{[sum(SEQ_OPS[k][j] for k in main_form(main_plan)) for j in range(4)]}"
          "): " + ", ".join(f"{k} {v:.3f} ms" for k, v in terms.items())
          + " (issue and mufu are not in the bound)", flush=True)
    loops = main_loops()
    warp_iters = slots // 32 * chunk
    for v in (64, 0):
        lp = loops[v]
        issue = lp["per_iteration"] * warp_iters / PEAK_ISSUE * 1e3
        print(f"variant {v} ({kernel_regs(v)}): iteration loop "
              f"{lp['loop'][0]}-{lp['loop'][1]}, {lp['static']} instructions "
              f"for {lp['iterations']} iteration(s), "
              f"{lp['per_iteration']:.1f} per iteration on the fast path "
              + ("(every switch case: an upper bound on the executed path) "
                 if v == 0 else f"(+ {lp['window']} in the window loop) ")
              + f"{lp['classes']}; kernel {turns[v][0]:.3f}, "
              f"{turns[v][1]:.3f} ms, bound {ft['bound_ms']:.2f} ms "
              f"({ft['bound_by']}), issue time {issue:.2f} ms [{card}]",
              flush=True)
    issue_ms = loops[64]["per_iteration"] * warp_iters / PEAK_ISSUE * 1e3
    ft["instantiation"] = ("fused_seq_kernel<OpSeq<kin, iso, sign>> "
                           "(variant 64)")
    # the engine can at best keep this kernel busy back to back: its rate
    # in photons (not padded slots) bounds the main path's rate
    kernel_rate = N * chunk / ft["ms"] * 1e3
    print(f"kin-iso-sign at {slots} slots x {chunk}: kernel {ft['ms']:.2f} "
          f"ms ({kernel_rate:.4e} photon-steps/s), twin "
          f"{ft['plain_ms']:.1f} ms, bound {ft['bound_ms']:.2f} ms "
          f"({ft['bound_by']}), issue time {issue_ms:.2f} ms per chunk "
          f"[{card}]", flush=True)
    del pk, outs, recs

    phase("fused_transport vs twin on the Planck source path's first chunk")
    packed, sched_p, seed_p, k_p, plan_p, starts_p = planck_chunk_inputs(
        phys, F, sampler, dev)
    tile = k_p * (plan_p.n_rec_cols + plan_p.n_frec_cols * 8) * 4
    grids = {}
    for kk in (K, k_p):
        grids[kk] = F.kernel_grid(plan_p, packed.shape[1], kk)
    n_starts = int((starts_p[0, :k_p] > -(2 ** 30)).sum())
    print(f"Planck chunk 0: {packed.shape[1]} slots x {k_p} iterations, ops "
          f"{[op.kind for op in plan_p.ops]}, iso lambda**-4 "
          f"{[op.wl_base is not None for op in plan_p.ops if op.kind == 'iso']}"
          f", {plan_p.n_rec_cols} int + {plan_p.n_frec_cols} float record "
          f"columns = {tile} B of record tiles per block; {n_starts} of {k_p} "
          f"iterations emit; grid {grids[k_p]} blocks (at {K} iterations: "
          f"{grids[K]})", flush=True)
    check(tile > 48 * 1024 and n_starts < k_p and plan_p.n_frec_cols
          and any(op.wl_base is not None for op in plan_p.ops),
          "the Planck chunk no longer covers the large-tile launch, the "
          "capacity stop, rec_f and lambda**-4 scattering")
    pft = {"plain_ms": compare("planck-chunk-0", packed, sched_p, k_p,
                               plan_p, starts_p, "planck", seed_p)}
    out = torch.empty_like(packed)
    pft["ms"] = cuda_ms(lambda: F.fused_transport(
        packed, out, sched_p, seed_p, k_p, plan_p, emit_starts=starts_p),
        3, torch)
    pft["bound_ms"], pft["bound_by"] = transport_bound(
        plan_p, packed.shape[1], k_p, starts_p)
    print(f"planck-chunk-0: kernel {pft['ms']:.2f} ms, twin "
          f"{pft['plain_ms']:.1f} ms, bound {pft['bound_ms']:.2f} ms "
          f"({pft['bound_by']}) per chunk [{card}]", flush=True)
    del packed, out, sched_p, starts_p

    phase("fused_transport vs twin on the media plans (2**20 slots, 256 "
          "iterations, 64**3 grids)")
    S_vox = 4 * C_LIGHT * MEDIA_DT
    mpk = torch.from_numpy(media_packed(1 << 20, S_vox, 64, 4)).to(dev)
    for name, plan in media_plans(F, light, K, S_vox, 64).items():
        plain_ms = compare(name, mpk, sched, K, plan, None, "media",
                           need_bitwise=True)
        out = torch.empty_like(mpk)
        F.fused_transport(mpk, out, sched, seed, K, plan)
        ms = cuda_ms(lambda: F.fused_transport(mpk, out, sched, seed, K,
                                               plan), 5, torch)
        times[name] = ms
        print(f"{name} at 2**20 x {K}: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.3f} ms per chunk [{card}]", flush=True)
    print("media-expr: planes bitwise equal to the twin on the card, so "
          "torch's CUDA exp and pow agree bitwise with the kernel's expf and "
          "powf on these inputs", flush=True)
    # the launcher's choice of instantiation: [kin, iso, sign] as is, and
    # with a constant n(r) = 1 field (same results, the field
    # instantiation), timed in turns
    bare = plan_of(("kin", "iso", "sign"), K)
    unit = F.FusedPlan(ops=[
        F._Op("kin"), F._Op("iso", coef=1e-6, c_val=C_LIGHT,
                            n_fn=light._compile_variable_n("1.0")),
        F._Op("sign", cols=(1, 2))], n_rec_cols=5, chunk=K,
        const_norm_speed=C_LIGHT)
    outs = [torch.empty_like(mpk) for _ in range(2)]
    recs = [F.fused_transport(mpk, o, sched, seed, K, p)[0]
            for o, p in zip(outs, (bare, unit))]
    torch.cuda.synchronize()
    check(torch.equal(recs[0], recs[1]) and torch.equal(*outs),
          "the field instantiation changed a field-free result")
    turns = {"without": [], "with": []}
    for name, p in (("without", bare), ("with", unit), ("with", unit),
                    ("without", bare)):
        turns[name].append(cuda_ms(lambda: F.fused_transport(
            mpk, outs[0], sched, seed, K, p), 5, torch))
    print(f"kin-iso-sign at 2**20 x 256 through its own instantiation "
          f"(variant {bare.kernel_variant}, no fields): "
          f"{turns['without'][0]:.3f}, {turns['without'][1]:.3f} ms; "
          f"with an n(r) = 1 field: {turns['with'][0]:.3f}, "
          f"{turns['with'][1]:.3f} ms (equal results) [{card}]", flush=True)
    del mpk, out, outs

    phase("fused_transport vs twin on the media path's first chunk")
    t0 = time.perf_counter()
    grid_m = media_grid(MEDIA_NV, 21)
    n_distinct = int(np.unique(grid_m).size)
    check(n_distinct > 256 and grid_m.min() >= 0.5 and grid_m.max() <= 3.0,
          f"phantom: {n_distinct} distinct values in [{grid_m.min()}, "
          f"{grid_m.max()}]")
    print(f"phantom: {MEDIA_NV}**3 float32 ({grid_m.nbytes / 2 ** 20:.0f} "
          f"MiB), {n_distinct} distinct values in [{grid_m.min():.3f}, "
          f"{grid_m.max():.3f}], built in {time.perf_counter() - t0:.1f} s")
    sim_m, *_ = media_sim(phys, grid_m, dev)
    packed, sched_m, seed_m, k_m, plan_m, _ = first_chunk_inputs(sim_m, F)
    del sim_m
    tile_m = k_m * (plan_m.n_rec_cols + plan_m.n_frec_cols * 8) * 4
    grid_blocks_m = F.kernel_grid(plan_m, packed.shape[1], k_m)
    print(f"media chunk 0: {packed.shape[1]} slots x {k_m} iterations, ops "
          f"{[op.kind for op in plan_m.ops]}, {plan_m.n_rec_cols} int + "
          f"{plan_m.n_frec_cols} float record columns = {tile_m} B of record "
          f"tiles per block; grid {grid_blocks_m} blocks "
          f"({grid_blocks_m / 132:.2f} per SM)", flush=True)
    check(tile_m > 48 * 1024 and plan_m.has_fields
          and [op.kind for op in plan_m.ops]
          == ["kin", "iso", "del", "absorb", "cross"],
          "the media chunk no longer covers the path's plan and the "
          "large-tile launch")
    mft = {"plain_ms": compare("media-chunk-0", packed, sched_m, k_m, plan_m,
                               None, "media", seed_m, need_bitwise=True)}
    out = torch.empty_like(packed)
    mft["ms"] = cuda_ms(lambda: F.fused_transport(
        packed, out, sched_m, seed_m, k_m, plan_m), 3, torch)
    mft["bound_ms"], mft["bound_by"] = transport_bound(
        plan_m, packed.shape[1], k_m, None)
    terms = bound_terms(*transport_counts(plan_m, packed.shape[1], k_m,
                                          None))
    print(f"media-chunk-0: kernel {mft['ms']:.2f} ms, twin "
          f"{mft['plain_ms']:.1f} ms, bound {mft['bound_ms']:.2f} ms "
          f"({mft['bound_by']}; ms per term: "
          + ", ".join(f"{k} {v:.2f}" for k, v in terms.items())
          + f") per chunk [{card}]", flush=True)
    del packed, out, sched_m

    phase("fused_transport vs twin on the stream and geometry plans (2**20 "
          "slots, 256 iterations)")
    L_geo = 64 * C_LIGHT * 0.001
    gpk = torch.from_numpy(geometry_packed(1 << 20, L_geo, 12)).to(dev)
    for name, plan in geometry_plans(F, K, L_geo).items():
        plain_ms = compare(name, gpk, sched, K, plan, None, "escape",
                           need_bitwise=True)
        out = torch.empty_like(gpk)
        F.fused_transport(gpk, out, sched, seed, K, plan)
        ms = cuda_ms(lambda: F.fused_transport(gpk, out, sched, seed, K,
                                               plan), 5, torch)
        times[name] = ms
        b_ms, b_by = transport_bound(plan, gpk.shape[1], K, None)
        print(f"{name} at 2**20 x {K}: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), stream "
              f"{stream_bytes(plan, gpk.shape[1]) / 2 ** 20:.0f} MiB per "
              f"chunk [{card}]", flush=True)
    del gpk, out

    eft = path_chunk0(
        "escape-chunk-0", escape_sim(phys, sampler, ESC_N, dev)[0], F,
        torch, compare, "escape", card,
        ["kin", "iso", "del", "cross", "scross", "sabsorb"])
    cft = path_chunk0(
        "cavity-chunk-0", cavity_sim(phys, CAV_N, dev)[0], F, torch,
        compare, "cavity", card, ["kin", "reflect", "iso", "trace"])

    rotation_plans(torch, F, light, dev, seed, compare, card, times)
    physics_gates(torch, F, light, dev, card)
    gft = path_chunk0(
        "gamma-chunk-0", gamma_sim(phys, GAMMA_N, dev)[0], F, torch,
        compare, "gamma", card, ["kin", "compton", "sign"], streams=False,
        twin_iters=TWIN_ITERS)
    sft = path_chunk0(
        "glass-chunk-0", glass_sim(phys, GLASS_N, dev)[0], F, torch,
        compare, "glass", card, ["kin", "fresnel", "fresnel", "cross"],
        streams=False, cross_p=1.0 / GLASS_ITERS)
    rft = {case: path_chunk0(
        f"{case}-chunk-0",
        run_all_sim(phys, case, RUN_ALL_N, dev, 1024)[0], F, torch,
        compare, case, card, kinds, streams=False,
        twin_iters=TWIN_ITERS if case == "thermal" else None)
        for case, kinds in (("thermal", ["kin", "compton", "sign"]),
                            ("stretch", ["kin", "del", "sign"]),
                            ("fluor", ["kin", "del"]))}
    lorentz_plan_phase(torch, F, dev, seed, compare, card, times)
    exft = path_chunk0(
        "exb-chunk-0", lorentz_sim(phys, "exb", EXB_N, dev,
                                   exb_iterations())[0], F, torch,
        compare, "lorentz", card, ["lorentz", "kin", "sign"], streams=False)
    mxft = path_chunk0(
        "mixed-chunk-0", lorentz_sim(phys, "mixed", MIX_N, dev,
                                     MIX_ITERS)[0], F, torch, compare,
        "mixed", card, ["lorentz", "kin", "iso", "del", "sign"],
        streams=False)
    tlft = path_chunk0(
        "tile-chunk-0", tile_sim(phys, TILE_N, dev, TILE_ITERS)[0], F, torch,
        compare, "record-tile", card, ["kin", "iso", "sign", "cross"],
        streams=False)
    pol_plan_phase(torch, F, light, dev, seed, compare, card, times)
    pol_law_phase(torch, F, dev, card)
    pol_grids = {}
    polft, poift = (path_chunk0(
        f"{case}-chunk-0", pol_sim(phys, case, n, dev)[0], F, torch,
        compare, case, card, kinds, streams=False, grids=pol_grids,
        twin_iters=TWIN_ITERS)
        for case, n, kinds in (("polarized", POL_N, ["kin", "pol"]),
                               ("polarimetry", POLI_N,
                                ["kin", "polc", "polmeas"])))
    user_plan_phase(torch, phys, F, dev, compare, card, times)
    uft = path_chunk0(
        "user-chunk-0", user_sim(phys, USER_N, dev)[0], F, torch, compare,
        "user", card, ["kin", "iso", "kstate", "custom", "reduce"],
        streams=False, twin_iters=TWIN_ITERS)
    spft = path_chunk0(
        "spectrum-chunk-0", spectrum_sim(phys, SPEC_N, dev)[0], F, torch,
        compare, "spectrum", card, ["kin", "compton", "reduce", "reduce"],
        streams=False)

    phase("planck_gen vs twin (10**7 samples)")
    n_gen = 10_000_000
    table = sampler.table(dev)
    got = P.planck_gen(seed, n_gen, table, 1.0, dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = P.planck_gen_reference(seed, n_gen, table, 1.0, dev)
    end.record()
    torch.cuda.synchronize()
    pg = {"plain_ms": start.elapsed_time(end)}
    check(torch.equal(got, want), "planck_gen differs from its twin "
          f"({int((got != want).sum())} of {n_gen} samples)")
    err["planck_gen"] = float((got - want).abs().max())
    pg["ms"] = cuda_ms(lambda: P.planck_gen(seed, n_gen, table, 1.0, dev),
                       20, torch)
    pg["bound_ms"], pg["bound_by"] = bound(
        4 * n_gen, OPS_PER_SAMPLE[0] * n_gen, OPS_PER_SAMPLE[1] * n_gen)
    E = got.double().cpu().numpy()
    edges, cdf = light.planck_cdf(a_E, b_E, T_SUN, 2000)
    q = np.array([0.05, 0.25, 0.5, 0.75, 0.95])
    exact_q = np.interp(q, np.concatenate([[0.0], cdf]), edges)
    q_err = float(np.max(np.abs(np.quantile(E, q) / exact_q - 1)))
    exact_mean = planck_mean(edges, cdf)
    mean_err = abs(float(E.mean()) / exact_mean - 1)
    check(q_err < 2e-3 and mean_err < 2e-3,
          f"planck_gen quantiles/mean off the CDF: {q_err:.2e} {mean_err:.2e}")
    print(f"planck_gen: bitwise equal to its twin, quantiles within "
          f"{q_err:.2e} and mean within {mean_err:.2e} of the analytic CDF; "
          f"kernel {pg['ms']:.4f} ms ({n_gen / pg['ms'] * 1e3:.4e} "
          f"samples/s), twin {pg['plain_ms']:.2f} ms, bound "
          f"{pg['bound_ms']:.4f} ms ({pg['bound_by']}) [{card}]", flush=True)
    del got, want, E

    phase("main path: 1e7 photons through Simulation")
    sim = phys.Simulation(exit=lambda s: s.t >= 5.0, seed=0,
                          chunk_steps=chunk, device="cuda")
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                               n=np.double(0.001)))
    meas = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, meas)
    sim.add_photons(light.generate_photon_state(N, E=1.0))
    print(sim.explain_plan())
    F.fused_transport.launches = F.fused_transport.seq_launches = 0
    P.planck_gen.launches = 0
    t0 = time.perf_counter()
    sim.start()
    sim.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = F.fused_transport.launches
    check(sim.used_fused, "main path did not take the fused tier")
    check(main_launches >= 4,
          f"only {main_launches} kernel launches on the main path")
    check(F.fused_transport.seq_launches == main_launches,
          f"{F.fused_transport.seq_launches} of {main_launches} main-path "
          "launches ran the op-sequence instantiation")
    data = np.asarray(meas.data)
    n_iter = len(sim.ts)
    check(data.shape == (n_iter, 5), f"records shape {data.shape}")
    check(n_iter >= 4 * chunk, f"{n_iter} iterations < 4 chunks")
    check(bool((data[:, 1] == N).all()), "photons lost without absorption")
    pcoll = 0.001 * 0.001 * float(light.c) * 0.001
    shares = data[:, 2] / np.maximum(data[:, 1], 1)
    expect = 0.5 + 0.5 * (1 - pcoll) ** np.arange(1, n_iter + 1)
    parity_err = float(np.abs(shares - expect).max())
    check(parity_err < 0.02, f"scatter parity broken: {parity_err}")
    st = sim.sim_state
    check(bool(torch.isfinite(st.r).all() and torch.isfinite(st.v).all()),
          "non-finite state")
    speed = torch.linalg.vector_norm(st.v[:, :N].double(), dim=0)
    check(float((speed / C_LIGHT - 1).abs().max()) < 1e-6,
          "|v| drifted off c")
    # device clock from the end of the first chunk to the end of the last:
    # device idle time between chunks (a host that falls behind) counts
    first_done, last_done = sim.chunk_log[0][2], sim.chunk_log[-1][2]
    steady_iters = sum(n for _, n, _ in sim.chunk_log[1:])
    steady_s = first_done.elapsed_time(last_done) * 1e-3
    rate = N * steady_iters / steady_s
    check(rate <= 1.05 * kernel_rate, f"main-path rate {rate:.4e} exceeds "
          f"the kernel-alone rate {kernel_rate:.4e}: timing is broken")
    print(f"main path: {n_iter} iterations in {len(sim.chunk_log)} chunks, "
          f"fused_transport launches {main_launches} (all of variant 64, the "
          f"op sequence), planck_gen launches "
          f"{P.planck_gen.launches}, parity err {parity_err:.2e}, wall "
          f"{wall:.2f} s from start() (set-up {sim.setup_seconds:.3f} s) = "
          f"{N * n_iter / wall:.4e} photon-steps/s")
    print(f"main path rate: {rate:.4e} photon-steps/s over the dispatch "
          f"loop after the first chunk ({steady_iters} iterations in "
          f"{steady_s * 1e3:.1f} ms of device time) [{card}]", flush=True)
    del sim, st, speed
    main_data, main_rate = data, rate

    phase("absorption: 2**20 photons, extinction exit")
    Na = 1 << 20
    sim = phys.Simulation(exit="extinction", seed=3, chunk_steps=64,
                          device="cuda")
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterDeleteStep(np.double(0.001),
                                            np.double(0.001)))
    meas = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, meas)
    sim.add_photons(light.generate_photon_state(Na, E=1.0))
    cap0 = pad_capacity(Na)
    F.fused_transport.launches = F.fused_transport.seq_launches = 0
    sim.start()
    sim.join()
    # at the default auto_shrink; pcoll = 0.3 empties the arena inside the
    # first chunk, and the host learns the alive count only when it
    # harvests that chunk, which ends the run: no boundary can shrink it
    # (the shrink phase below runs a slower absorber)
    shrinks = [e for e in sim.population_log if e[0] == "shrink"]
    check(sim.auto_shrink and not shrinks and len(sim.ts) <= 64
          and sim.sim_state.capacity == cap0,
          f"absorption: {len(sim.ts)} iterations, capacity "
          f"{sim.sim_state.capacity}, shrinks {shrinks}")
    check(F.fused_transport.seq_launches == F.fused_transport.launches > 0,
          f"{F.fused_transport.seq_launches} of {F.fused_transport.launches} "
          "extinction-run launches ran the [kin, del, sign] instantiation")
    data = np.asarray(meas.data)
    n = data[:, 1]
    q_k = (1 - pcoll) ** np.arange(1, len(n) + 1)
    sigma = np.sqrt(Na * q_k * (1 - q_k))
    worst = float(np.max(np.abs(n - Na * q_k) / np.maximum(sigma, 1.0)))
    check(worst <= 5.0, f"alive counts off the (1-p)^k law: {worst:.2f} sigma")
    check(n[-1] == 0 and bool((n[:-1] > 0).all()),
          "extinction exit did not stop at the first empty iteration")
    check(len(sim.ts) == len(n), "ts and records disagree")
    print(f"absorption: extinct after {len(n)} iterations in "
          f"{F.fused_transport.launches} launches of variant 65, worst "
          f"deviation {worst:.2f} sigma; capacity {cap0} before, "
          f"{sim.sim_state.capacity} after, shrinks (chunk, before, after) "
          f"{[e[1:] for e in shrinks]}", flush=True)
    del sim

    planck = planck_path(torch, phys, F, P, sampler, dev, card)
    beer_lambert(torch, phys, grid_m, dev, card, grid_blocks_m)
    media = media_path(torch, phys, F, grid_m, dev, card, mft)
    escape = escape_path(torch, phys, F, sampler, dev, card, eft, light)
    cavity = cavity_path(torch, phys, F, dev, card, cft)
    card_vs_cpu(torch, phys, F, sampler, err)
    media_card_vs_cpu(torch, phys, F, err)
    geometry_card_vs_cpu(torch, phys, F, sampler, err)
    gamma = gamma_path(torch, phys, F, dev, card, gft)
    glass = glass_path(torch, phys, F, dev, card, sft)
    runs = run_all_paths(torch, phys, F, dev, card)
    tissue_card_vs_cpu(torch, phys, F)
    lruns = lorentz_runs(torch, phys, F, dev, card, exft, mxft, tlft)
    pruns = pol_paths(torch, phys, F, dev, card, polft, poift, pol_grids)
    uruns = user_paths(torch, phys, F, dev, card, uft, spft)
    generic_paths(torch, phys, F, P, dev, card, main_data, main_rate)
    recorded_plan_phase(torch, phys, F, dev, compare, card, times)
    mir_ft, mir_launches, _ = mirror_path(torch, phys, F, dev, card, compare)
    phf_ft, phf_launches, _ = phase_function_path(torch, phys, F, dev, card,
                                                  compare)
    generic_scatter_paths(torch, phys, F, dev, card)
    shrink_path(torch, phys, F, dev, card, compare)
    inj_ft, inj_sim = injection_path(torch, phys, F, dev, card, compare)
    checkpoint_path(torch, phys, F, inj_sim, dev, card)
    del inj_sim
    midrun_card_vs_cpu(torch, phys, F, dev)
    sorted_media_path(torch, phys, F, grid_m, dev, card)
    bridge_and_profiling(torch, phys, F, dev, card)
    mesh_ft, mesh_data, mesh_plan = mesh_path(torch, phys, F, dev, card,
                                              compare)
    functional_path(torch, phys, dev, card)
    mp_ft = mp_path(torch, dev, card, compare, mesh_ft, mesh_data,
                    mesh_plan)

    ft_src = {"name": "fused_transport", "route": "cuda",
              "source": "physicl_tpu_torch/csrc/fused_transport.cu",
              "replaces": "physicl_tpu/ops/fused.py:1652"}
    new_paths = [
        {**ft_src, "path": "gamma", "launches": gamma["fused_launches"],
         "max_abs_err": err["gamma"], **gft, "library_ms": None},
        {**ft_src, "path": "glass", "launches": glass["fused_launches"],
         "max_abs_err": err["glass"], **sft, "library_ms": None}]
    new_paths += [{**ft_src, "path": case,
                   "launches": runs[case]["fused_launches"],
                   "max_abs_err": err[case], **rft[case], "library_ms": None}
                  for case in ("thermal", "stretch", "fluor")]
    new_paths += [{**ft_src, "path": path, "launches":
                   lruns[run]["fused_launches"], "max_abs_err": err[path],
                   **entry, "library_ms": None}
                  for path, run, entry in (("lorentz", "exb", exft),
                                           ("mixed", "mixed", mxft),
                                           ("record-tile", "tile", tlft))]
    new_paths += [{**ft_src, "path": path, "launches":
                   pruns[path]["fused_launches"],
                   "max_abs_err": max(err["pol"], err[path]), **entry,
                   "library_ms": None}
                  for path, entry in (("polarized", polft),
                                      ("polarimetry", poift))]
    # kernel 1i: the user ops of the same kernel, in a library generated
    # for each plan
    new_paths += [{**ft_src, "replaces": "physicl_tpu/ops/fused.py:1448",
                   "generated_by": "physicl_tpu_torch/ops/codegen.py",
                   "path": path, "launches": uruns[path]["fused_launches"],
                   "max_abs_err": max(err["user"], err[path]), **entry,
                   "library_ms": None}
                  for path, entry in (("user", uft), ("spectrum", spft))]
    # the recorded fields and inverse CDFs
    new_paths += [
        {**ft_src, "path": path, "launches": launches,
         "max_abs_err": err[path], **entry, "library_ms": None}
        for path, launches, entry in (("mirror", mir_launches, mir_ft),
                                      ("phase-icdf", phf_launches, phf_ft))]
    # the main path with 2**20 photons injected mid-run: the first chunk at
    # the grown capacity (variant 64)
    new_paths.append({**ft_src, "path": "main-injected",
                      "max_abs_err": err["main-injected"], **inj_ft,
                      "library_ms": None})
    # the main path over an 8-shard mesh on one card: ms is the chunk of
    # the 8 launches together, the bound the whole chunk's
    new_paths.append({**ft_src, "path": "main-mesh8",
                      "max_abs_err": err["main-mesh"], **mesh_ft,
                      "library_ms": None})
    # the same over 2 processes sharing the card, 4 shards each: ms is the
    # mean chunk of a process's 4 launches on its own clock, launches both
    # processes' together
    new_paths.append({**ft_src, "path": "main-mp",
                      "max_abs_err": err["main-mp"], **mp_ft,
                      "library_ms": None})
    print(json.dumps({"kernels": new_paths + [
        {**ft_src, "path": "main", "launches": main_launches,
         "max_abs_err": err["main"], **ft, "library_ms": None},
        {**ft_src, "path": "planck", "launches": planck["fused_launches"],
         "max_abs_err": err["planck"], **pft, "library_ms": None},
        {**ft_src, "path": "media", "launches": media["fused_launches"],
         "max_abs_err": err["media"], **mft, "library_ms": None},
        {**ft_src, "path": "escape", "launches": escape["fused_launches"],
         "max_abs_err": err["escape"], **eft, "library_ms": None},
        {**ft_src, "path": "cavity", "launches": cavity["fused_launches"],
         "max_abs_err": err["cavity"], **cft, "library_ms": None},
        {"name": "planck_gen", "route": "cuda",
         "source": "physicl_tpu_torch/csrc/planck_gen.cu",
         "replaces": "physicl_tpu/light.py:332", "path": "planck",
         "launches": planck["planck_launches"],
         "max_abs_err": err["planck_gen"], **pg, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# -- the generic step tier -----------------------------------------------------

GEN_N = 10_000_000       # the bench.py workload's width
GEN_ITERS = 1024         # four chunks of 256
GEN_CHUNK = 256
GEN_PROF_ITERS = 512     # the profiled second run: two chunks
GEN_FALLBACK_ITERS = 256
SHIELD_N = 500_000       # deep shield (examples/make_split_nb.py's slab)
SHIELD_CAP = 1 << 24     # 33x headroom against the example's 21x
SHIELD_ITERS = 300
SHIELD_BANDS = 8         # independent photon groups: the batch variance
SHIELD_WTOL = 1e-6       # split weight conservation (float32 w / n, f64 sums)


def host_kahan(dt, n):
    """``n`` iterations of the float32 Kahan clock on the host."""
    f32 = np.float32
    t, comp, out = f32(0), f32(0), np.zeros(n, f32)
    for i in range(n):
        y = f32(f32(dt) - comp)
        t_new = f32(t + y)
        comp = f32(f32(t_new - t) - y)
        t = t_new
        out[i] = t
    return out


def device_idle(prof, torch):
    """(busy ms, span ms, kernel names) of the card in a profiled window,
    from its first to its last device activity (kernels, copies, fills)."""
    acts = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    check(acts, "no device activity in the trace")
    lo, hi = min(a[0] for a in acts), max(a[1] for a in acts)
    busy, end = 0.0, lo
    for s, e, _ in sorted(acts):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy * 1e-6, (hi - lo) * 1e-6, {a[2] for a in acts}


def generic_main_sim(phys, n, iters, dev, dt_fn=None, fuse="off"):
    """The bench.py workload (UpdateTime, kin, iso(A = n = 1e-3), sign) for
    ``iters`` iterations in chunks of 256."""
    light = phys.light
    sim = phys.Simulation(until_t=(iters - 0.5) * 0.001, seed=21,
                          chunk_steps=GEN_CHUNK, fuse=fuse, device=dev)
    sim.add_step(0, phys.UpdateTimeStep(dt_fn or (lambda s: np.double(0.001))))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                               n=np.double(0.001)))
    meas = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, meas)
    sim.add_photons(light.generate_photon_state(n, E=1.0, device=dev))
    return sim, meas


def plus_x_sigmas(data, n, pcoll):
    """Largest |+x count - N s_k| / sigma_k over the iterations, with s_k =
    0.5 + 0.5 (1 - p)**k the +x share after k iterations (each scatter,
    n_alive * p per iteration on average, leaves +x with probability 1/2)."""
    k = np.arange(1, len(data) + 1)
    s = 0.5 + 0.5 * (1 - pcoll) ** k
    return float(np.max(np.abs(data[:, 2] - n * s)
                        / np.sqrt(n * s * (1 - s))))


def generic_paths(torch, phys, F, P, dev, card, main_data, main_rate):
    """The generic step tier on the card: the bench.py workload with
    fuse="off", the fallback through a refusal, and the deep shield."""
    import warnings

    light = phys.light
    pcoll = 0.001 * 0.001 * float(light.c) * 0.001

    phase("generic main path: 1e7 photons, fuse='off'")
    sim, meas = generic_main_sim(phys, GEN_N, GEN_ITERS, dev)
    plan = sim.explain_plan()
    check(plan.startswith(f"execution mode: generic (chunk={GEN_CHUNK}"),
          f"not the generic tier:\n{plan}")
    F.fused_transport.launches = F.fused_transport.seq_launches = 0
    P.planck_gen.launches = 0
    wall, _, peak = run_sim(torch, sim)
    check(not sim.used_fused, "fuse='off' ran the fused tier")
    check(F.fused_transport.launches == 0 and P.planck_gen.launches == 0,
          f"{F.fused_transport.launches} fused_transport launches on the "
          "generic tier")
    st = sim.sim_state
    check(st.r.device.type == "cuda" and st.key.device.type == "cuda",
          f"state on {st.r.device}, generator on {st.key.device}")
    data = np.asarray(meas.data)
    check(data.shape == (GEN_ITERS, 5), f"records shape {data.shape}")
    check(bool((data[:, 1] == GEN_N).all()), "photons lost")
    ts_ok = (np.asarray(sim.ts, np.float32).tobytes()
             == host_kahan(0.001, GEN_ITERS).tobytes())
    check(ts_ok, "generic sim.ts differs from the host's float32 replay")
    z_gen = plus_x_sigmas(data, GEN_N, pcoll)
    z_fused = plus_x_sigmas(main_data[:GEN_ITERS], GEN_N, pcoll)
    check(z_gen < 5 and z_fused < 5, f"+x counts off the scatter law: "
          f"generic {z_gen:.2f} sigma, fused {z_fused:.2f} sigma")
    diff = data[:, 2] - main_data[:GEN_ITERS, 2]
    k = np.arange(1, GEN_ITERS + 1)
    s = 0.5 + 0.5 * (1 - pcoll) ** k
    z_diff = float(np.max(np.abs(diff) / np.sqrt(2 * GEN_N * s * (1 - s))))
    check(z_diff < 5, f"generic and fused +x counts differ by {z_diff:.2f} "
          "sigma")
    check(bool(torch.isfinite(st.r).all() and torch.isfinite(st.v).all()),
          "non-finite state")
    rate, steady_s = steady_rate(sim, np.full(GEN_ITERS, GEN_N))
    print(f"generic main path: {GEN_ITERS} iterations in "
          f"{len(sim.chunk_log)} chunks of {GEN_CHUNK}, no fused_transport "
          f"launch, state and generator on {st.r.device}; sim.ts "
          f"byte-identical to the host replay; +x counts within "
          f"{z_gen:.2f} sigma of the law (fused main path {z_fused:.2f}, "
          f"generic - fused {z_diff:.2f}); wall {wall:.2f} s from start(), "
          f"peak {peak / 2**30:.2f} GiB")
    print(f"generic main path rate: {rate:.4e} photon-steps/s over the "
          f"dispatch loop after the first chunk ({steady_s * 1e3:.1f} ms of "
          f"device time), fused main path {main_rate:.4e} "
          f"({main_rate / rate:.1f}x) [{card}]", flush=True)
    del sim, st

    sim, _ = generic_main_sim(phys, GEN_N, GEN_PROF_ITERS, dev)
    _, prof, _ = run_sim(torch, sim, profile=True)
    busy, span, names = device_idle(prof, torch)
    check(not any("fused_transport" in nm for nm in names),
          "a fused_transport kernel in the generic tier's trace")
    print(f"generic main path device idle share (profiled second run, "
          f"{GEN_PROF_ITERS} iterations, first to last device activity): "
          f"{1 - busy / span:.4f} ({busy:.1f} of {span:.1f} ms busy; "
          f"{len(names)} distinct kernels, none of them fused_transport) "
          f"[{card}]", flush=True)
    del sim, prof

    phase("fallback: a dt function that reads n_objects")
    sim, meas = generic_main_sim(phys, GEN_N, GEN_FALLBACK_ITERS, dev,
                                 dt_fn=lambda s: 0.001 + 0 * s.n_objects,
                                 fuse="auto")
    plan = sim.explain_plan()
    check("refused [dt-fn-not-t-only]" in plan, f"no refusal:\n{plan}")
    F.fused_transport.launches = 0
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        wall, _, _ = run_sim(torch, sim)
    warned = [w for w in record if issubclass(w.category, RuntimeWarning)]
    check(len(warned) == 1 and "dt-fn-not-t-only" in str(warned[0].message),
          f"fallback warnings: {[str(w.message) for w in warned]}")
    check(not sim.used_fused and F.fused_transport.launches == 0,
          "the refused plan ran the fused tier")
    data = np.asarray(meas.data)
    check(data.shape == (GEN_FALLBACK_ITERS, 5)
          and plus_x_sigmas(data, GEN_N, pcoll) < 5,
          "fallback run: records off the law")
    check(np.asarray(sim.ts, np.float32).tobytes()
          == host_kahan(0.001, GEN_FALLBACK_ITERS).tobytes(),
          "fallback sim.ts differs from the host replay")
    print(f"fallback: refused [dt-fn-not-t-only], one RuntimeWarning, "
          f"{GEN_FALLBACK_ITERS} iterations on the generic tier in "
          f"{wall:.2f} s [{card}]", flush=True)
    del sim

    return deep_shield(torch, phys, F, dev, card)


def shield_sim(phys, mode, dev, n=SHIELD_N, cap=SHIELD_CAP,
               iters=SHIELD_ITERS, seed=100):
    """examples/make_split_nb.py's slab: 36 steps deep, p_abs 0.06, p_scat
    0.16 a step, importance doubling every 4 steps (``split``: at="step",
    the generic tier; ``split_chunk``: at="chunk" between fused dispatches
    of 8), transmission tallied (weighted for the split modes) at the exit
    plane, then killed. The photons carry a ``band`` plane (their index mod
    SHIELD_BANDS, copied into every split copy), so that a per-band tally
    gives the batch variance of each mode from one run."""
    light, torch = phys.light, __import__("torch")
    c = float(light.c)
    dt = 0.001
    step = c * dt
    L = 36 * step
    kw = {"chunk_steps": 8} if mode == "split_chunk" else {}
    s = phys.Simulation(until_t=iters * dt * 0.9999, seed=seed, capacity=cap,
                        device=dev, **kw)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(dt)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(n=np.double(1.0),
                                             A=np.double(0.16 / step)))
    s.add_step(3, light.ScatterDeleteStep(np.double(1.0),
                                          np.double(0.06 / step)))
    split = None
    if mode != "analog":
        split = light.ImportanceSplitStep(
            lambda x, y, z: 2.0 ** torch.floor(
                torch.clamp(x, 0.0, L) / (4.0 * step)),
            at="chunk" if mode == "split_chunk" else "step")
        s.add_step(4, split)
    weighted = mode != "analog"
    meas = light.ScatterMeasureStep(None, True, [[np.double(L), np.nan,
                                                  np.nan]],
                                    weighted=weighted)
    s.add_step(5, meas)

    def bands(p):
        crossed = (((p.rx - p.drx <= L) & (L <= p.rx))
                   | ((p.rx - p.drx >= L) & (L >= p.rx))) & p.alive
        val = torch.where(crossed, p.w if weighted else p.w * 0 + 1, 0.0)
        return {f"b{b}": torch.where(p.extras["band"] == b, val, 0.0)
                for b in range(SHIELD_BANDS)}

    tally = phys.ReduceMeasureStep(
        None, bands, outputs=tuple(f"b{b}" for b in range(SHIELD_BANDS)),
        extras=("band",))
    s.add_step(6, tally)
    big = 1e12
    s.add_step(7, phys.newton.AbsorbingBoundaryStep(
        ((-10 * step, L), (-big, big), (-big, big))))
    bulk = light.generate_photon_state(n, E=1.0)
    bulk["extras"] = {"band": (np.arange(n) % SHIELD_BANDS).astype(
        np.float32)}
    s.add_photons(bulk)
    return s, meas, tally, split


def audit_weight(split, torch):
    """Wrap a split step so that every pass (each iteration at="step",
    each boundary at="chunk") measures, on the device, how far the split
    moved the total weight of the particles it may split (the roulette
    set excluded: its weight is kept in expectation only). Returns a list
    holding the worst relative change (a device scalar) and the pass
    count."""
    worst = [None, 0]
    orig = split._apply_ratios

    def audited(state, ctx, split_q, roul_q):
        out = orig(state, ctx, split_q, roul_q)
        rq = torch.where(state.alive, torch.as_tensor(
            roul_q, dtype=state.w.dtype, device=state.device), 1.0)
        keep = state.alive & ~(rq < 1.0) if split.roulette else state.alive
        slots = torch.arange(state.capacity, device=state.device)
        copies = (slots >= state.n_spawned) & (slots < out.n_spawned)
        before = (state.w.double() * keep).sum()
        after = (out.w.double() * (keep | copies)).sum()
        rel = (after - before).abs() / before.clamp(min=1e-300)
        worst[0] = rel if worst[0] is None else torch.maximum(worst[0], rel)
        worst[1] += 1
        return out

    split._apply_ratios = audited
    return worst


def deep_shield(torch, phys, F, dev, card):
    phase("deep shield: analog, split (generic), split_chunk (fused)")
    res = {}
    for mode in ("analog", "split", "split_chunk"):
        sim, meas, tally, split = shield_sim(phys, mode, dev)
        audit = audit_weight(split, torch) if split is not None else None
        F.fused_transport.launches = 0
        with __import__("warnings").catch_warnings():
            __import__("warnings").simplefilter("ignore", RuntimeWarning)
            wall, _, peak = run_sim(torch, sim)
        launches = F.fused_transport.launches
        rows = np.asarray(meas.data, np.float64)
        T_tally = rows[:, 2].sum() / SHIELD_N
        b = np.asarray([row[1:] for row in tally.data], np.float64).sum(0)
        T_b = b / (SHIELD_N / SHIELD_BANDS)
        T_mean = float(T_b.mean())
        sigma = float(T_b.std(ddof=1) / np.sqrt(SHIELD_BANDS))
        check(abs(T_mean - T_tally) <= 1e-5 * max(T_tally, 1e-30),
              f"{mode}: band tallies {T_mean:.6e} != plane tally "
              f"{T_tally:.6e}")
        check(len(sim.ts) == SHIELD_ITERS, f"{mode}: {len(sim.ts)} "
              "iterations")
        steps = float(rows[:, 1].sum())  # alive particle-steps
        line = (f"deep shield {mode}: T = {T_mean:.4e} +- {sigma:.2e} "
                f"({SHIELD_BANDS} bands), plane tally {T_tally:.4e}, "
                f"fused={sim.used_fused}, fused_transport launches "
                f"{launches}, wall {wall:.2f} s from start(), "
                f"{steps:.4e} particle-steps = {steps / wall:.4e}/s, peak "
                f"{peak / 2**30:.2f} GiB")
        if mode == "analog":
            check(sim.used_fused and launches > 0, "analog: not fused")
        elif mode == "split":
            check(not sim.used_fused and launches == 0,
                  "split (at='step'): not the generic tier")
        else:
            check(sim.used_fused and launches > 0,
                  "split_chunk: fused_transport did not run")
        if audit is not None:
            worst = float(audit[0]) if audit[0] is not None else 0.0
            check(audit[1] > 0 and worst <= SHIELD_WTOL,
                  f"{mode}: split changed the weight by {worst:.2e} "
                  f"(> {SHIELD_WTOL}) over {audit[1]} passes")
            line += (f"; weight conserved to {worst:.2e} over {audit[1]} "
                     "passes")
        print(line + f" [{card}]", flush=True)
        res[mode] = (T_mean, sigma, wall)
        del sim
    for a, b in (("analog", "split"), ("analog", "split_chunk"),
                 ("split", "split_chunk")):
        (ta, sa, _), (tb, sb, _) = res[a], res[b]
        z = abs(ta - tb) / np.hypot(sa, sb)
        check(z <= 5, f"deep shield: {a} and {b} transmissions differ by "
              f"{z:.2f} sigma")
        print(f"deep shield: {a} vs {b}: {z:.2f} combined sigma")
    return res


def device_busy(prof, torch):
    """(busy ms, span ms) of the card in a profiled window, from the first
    to the last fused_transport kernel: the union of every device activity
    (kernels, copies, fills) over that span. Fails if the trace holds no
    transport kernel."""
    acts = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    kern = [a for a in acts if "fused_transport_kernel" in a[2]]
    check(kern, f"no fused_transport kernel among the {len(acts)} device "
          "activities of the trace")
    lo, hi = min(a[0] for a in kern), max(a[1] for a in kern)
    busy, end = 0.0, lo
    for s, e, _ in sorted(a for a in acts if a[1] > lo and a[0] < hi):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy * 1e-6, (hi - lo) * 1e-6


def planck_sim(phys, sampler, bulk, dev):
    """The Planck source path's ``Simulation`` (phase 8) on the initial
    population ``bulk``: returns ``(sim, crossing step)``."""
    light = phys.light
    c_dt = float(light.c) * PLANCK_DT
    hc = float(light.h) * float(light.c)
    E_mean = planck_mean(*light.planck_cdf(sampler.E_min, sampler.E_max,
                                           T_SUN, 2000))
    # scattering: the mean-energy photon has pcoll ~ 0.05 per iteration
    # (examples/presentation_example.py)
    A_sc = 0.05 / (c_dt * (hc / E_mean) ** -4)
    L = 10 * c_dt
    sim = phys.Simulation(until_t=(PLANCK_ITERS - 0.5) * PLANCK_DT, seed=11,
                          capacity=PLANCK_CAP, device=dev)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(PLANCK_DT)))
    sim.add_step(1, light.PhotonEmitterStep(PLANCK_EMIT, E=sampler,
                                            isotropic=True))
    sim.add_step(2, phys.newton.NewtonianKinematicsStep())
    sim.add_step(3, light.ScatterIsotropicStep(
        A=A_sc, wavelength_dep_scattering=True))
    sim.add_step(4, light.ScatterDeleteStep(1.0, PLANCK_P_DEL / c_dt))
    meas = light.ScatterMeasureStep(
        None, True, [(L, np.nan, np.nan), (-L, np.nan, np.nan)],
        measure_E=True, measure_E_mode="sum")
    sim.add_step(5, meas)
    sim.add_photons(bulk)
    return sim, meas


def planck_chunk_inputs(phys, F, sampler, dev):
    """The arguments the Planck source path's provider hands the kernel for
    its first chunk (``first_chunk_inputs``)."""
    light = phys.light
    E0 = sampler.sample_device(7, PLANCK_N0, device=dev)
    sim, _ = planck_sim(phys, sampler, light.generate_photon_state(
        PLANCK_N0, E=E0, device=dev), dev)
    del E0
    return first_chunk_inputs(sim, F)


def planned(sim):
    """``(state, provider)`` of ``sim`` planned as ``start()`` plans it (its
    fused plan is ``provider.plan``)."""
    state = sim._init_run_state()
    steps = sim._ordered_steps()
    for s in steps:
        s.setup(sim)
    return state, sim._build_execution(steps, state).provider


def first_chunk_inputs(sim, F):
    """The arguments a path's provider hands the kernel for its first chunk,
    ``(packed, sched, seed, k_act, plan, emit_starts)``: the path's
    ``Simulation`` is planned as ``start()`` plans it and its first chunk
    dispatched once, with ``fused_chunk`` wrapped to record its inputs (the
    dispatch leaves them unchanged: it writes a fresh buffer)."""
    state, provider = planned(sim)
    seen = []
    launch = F.fused_chunk

    def recorded(packed, sched, seed, k_act, plan, out=None,
                 emit_starts=None):
        seen.append((packed, sched, seed, k_act, plan, emit_starts))
        return launch(packed, sched, seed, k_act, plan, out=out,
                      emit_starts=emit_starts)

    F.fused_chunk = recorded
    try:
        provider.dispatch(state)
    finally:
        F.fused_chunk = launch
    check(len(seen) == 1, f"{len(seen)} launches for one chunk")
    return seen[0]


def media_grid(n, seed):
    """The CT-scale phantom: a smooth continuous float32 density in [0.5,
    3] (a background of 0.5, five Gaussian blobs and a dense rod along z),
    from ``seed``."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n, dtype=np.float32)
    g = np.full((n, n, n), 0.5, np.float32)
    for _ in range(5):
        c = rng.uniform(0.2, 0.8, 3)
        sig, a = rng.uniform(0.06, 0.15), rng.uniform(0.5, 1.5)
        e = [np.exp(-(x - ci) ** 2 / (2 * sig ** 2)).astype(np.float32)
             for ci in c]
        g += np.float32(a) * e[0][:, None, None] * e[1][None, :, None] \
            * e[2][None, None, :]
    rod = np.exp(-((x[:, None] - 0.6) ** 2 + (x[None, :] - 0.4) ** 2)
                 / (2 * 0.03 ** 2)).astype(np.float32)
    g += np.float32(1.5) * rod[:, :, None]
    np.clip(g, 0.5, 3.0, out=g)
    return g


def media_sim(phys, grid, dev, n=None, iters=None, scatter=True,
              roulette=MEDIA_ROULETTE, seed=13, chunk=None, del_fn=None,
              sign=False):
    """The media path's ``Simulation``: a +x beam at c from x = -0.75 voxel,
    y and z uniform over the grid's face, through ``voxel_density(grid,
    spacing=4 c dt, interp="trilinear")``: UpdateTime, kinematics,
    isotropic scattering and implicit-capture absorption sharing the field
    (roulette, deposition), the absorbing box one voxel outside the
    coverage, and a weighted far-face tally with energy sums; ``del_fn``
    gives absorption another field, ``sign`` adds a weighted sign tally.
    Returns ``(sim, delete step, far-face tally, sign tally or None,
    field)``."""
    import torch

    n = MEDIA_N if n is None else n
    iters = MEDIA_ITERS if iters is None else iters
    light = phys.light
    c_dt = float(light.c) * MEDIA_DT
    sp = 4 * c_dt
    nv = grid.shape[0]
    nfn = light.voxel_density(grid, spacing=sp, interp="trilinear")
    sim = phys.Simulation(until_t=(iters - 0.5) * MEDIA_DT, seed=seed,
                          chunk_steps=chunk, device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(MEDIA_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    if scatter:
        sim.add_step(2, light.ScatterIsotropicStep(
            A=MEDIA_AS / c_dt, variable_n=True, variable_n_fn=nfn))
    dele = light.ScatterDeleteStep(
        1.0, MEDIA_AA / c_dt, variable_n=True,
        variable_n_fn=nfn if del_fn is None else del_fn,
        implicit_capture=True, roulette=roulette, measure_deposition=True)
    sim.add_step(3, dele)
    if scatter:
        sim.add_step(4, phys.newton.AbsorbingBoundaryStep(
            ((-sp, nv * sp),) * 3))
    meas = light.ScatterMeasureStep(
        None, True, [((nv - 1) * sp, np.nan, np.nan)], weighted=True,
        measure_E=True, measure_E_mode="sum")
    sim.add_step(5, meas)
    if sign:
        sign = light.ScatterSignMeasureStep(None, True, weighted=True)
        sim.add_step(6, sign)
    else:
        sign = None
    gen = torch.Generator().manual_seed(seed)
    yz = torch.rand((2, n), generator=gen, dtype=torch.float64) \
        * ((nv - 1) * sp)
    r = torch.cat([torch.full((1, n), -0.75 * sp, dtype=torch.float64), yz])
    sim.add_photons(light.generate_photon_state(n, E=1.0, r=r, device=dev))
    return sim, dele, meas, sign, nfn


def media_packed(C, S, nv, seed):
    """Seeded (15, C) packed photons spread over (and a voxel beyond) an
    nv**3 grid of spacing S, random directions at c, ~90% alive."""
    rng = np.random.default_rng(seed)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.uniform(-1.0, nv + 1.0, (3, C)) * S
    d = rng.normal(size=(3, C))
    p[6:9] = d / np.linalg.norm(d, axis=0) * C_LIGHT
    p[12] = rng.uniform(0.5, 2.0, C)
    p[13] = rng.uniform(size=C) < 0.9
    p[14] = 1.0
    return p


def media_plans(F, light, chunk, S, nv, seed=0):
    """Four media plans: trilinear voxel with implicit capture, roulette,
    deposition, absorb and weighted sign; nearest voxel with analog del and
    deposition; layered r and z; C expressions for n (exp, pow, fmin) and
    A(E) (tests/test_torch_cuda.py holds the same plans at 2**16 x 64)."""
    rng = np.random.default_rng(seed)
    grid = (1.0 + 2.0 * rng.uniform(size=(nv,) * 3)).astype(np.float32)
    tri = light.voxel_density(grid, spacing=S, interp="trilinear")
    near = light.voxel_density(grid, spacing=S, outside=0.5)
    half = nv * S / 2
    lay_r = light.layered_density(np.array([0.0, 0.3, 0.6, 2.0]) * half,
                                  [2.5, 1.0, 0.5], axis="r",
                                  center=(half, half, half))
    lay_z = light.layered_density(np.array([0.0, 0.5, 1.2, 2.0]) * half,
                                  [1.0, 3.0, 2.0], axis="z", outside=0.25)
    expr = light._compile_variable_n(
        f"fmin(exp(-fabs(r0[gid] - {half}) / {half}) * 3.0, "
        f"pow(fabs(r1[gid]) / {half} + 0.5, 1.5)) + 0.25")
    a_fn = light._compile_field_expr("(1.5 / E[gid]) ** 3 + 0.1 * E[gid]",
                                     ("E",), "A_fn")
    c_dt = C_LIGHT * MEDIA_DT
    a_s, a_a = 0.01 / c_dt, 0.004 / c_dt
    box = ((-0.5 * S, (nv - 0.5) * S),) * 3

    def plan(ops, n_rec, n_f):
        return F.FusedPlan(ops=ops, n_rec_cols=n_rec, chunk=chunk,
                           const_norm_speed=C_LIGHT, n_frec_cols=n_f)

    return {
        "media-voxel-trilinear-capture": plan([
            F._Op("kin"),
            F._Op("iso", coef=a_s, c_val=C_LIGHT, n_fn=tri),
            F._Op("del", coef=a_a, n_fn=tri, implicit_capture=True,
                  roulette=(0.7, 0.9), cols=(0,)),
            F._Op("absorb", bounds=box),
            F._Op("sign", cols=(1, 1), weighted=True)], 2, 4),
        "media-voxel-nearest-analog": plan([
            F._Op("kin"),
            F._Op("iso", coef=a_s, c_val=C_LIGHT, n_fn=near),
            F._Op("del", coef=a_a, n_fn=near, cols=(0,)),
            F._Op("sign", cols=(1, 2))], 5, 1),
        "media-layered-r-z": plan([
            F._Op("kin"),
            F._Op("iso", coef=a_s, c_val=C_LIGHT, n_fn=lay_r),
            F._Op("del", coef=a_a, n_fn=lay_z),
            F._Op("sign", cols=(1, 2))], 5, 0),
        "media-expr": plan([
            F._Op("kin"),
            F._Op("iso", coef=a_s, c_val=C_LIGHT, n_fn=expr),
            F._Op("del", coef=a_a, n_fn=expr, a_fn=a_fn, cols=(0,)),
            F._Op("sign", cols=(1, 2))], 5, 1),
    }


def geometry_packed(C, L, seed):
    """Seeded (15, C) packed photons uniform in the box [0, L]**3, random
    directions at c, energies in [0.5, 2], ~90% alive."""
    rng = np.random.default_rng(seed)
    p = np.zeros((15, C), np.float32)
    p[0:3] = rng.uniform(0.0, L, (3, C))
    d = rng.normal(size=(3, C))
    p[6:9] = d / np.linalg.norm(d, axis=0) * C_LIGHT
    p[12] = rng.uniform(0.5, 2.0, C)
    p[13] = rng.uniform(size=C) < 0.9
    p[14] = 1.0
    return p


def geometry_plans(F, chunk, L):
    """The four stream and geometry plans over the box [0, L]**3 (c dt =
    L / 64): a reflecting box traced in float32 with scatter flags; a
    periodic box traced in bfloat16 every 4th iteration; analog absorption,
    a weighted shell tally, a central absorber and a plane capturing
    energies; an escape sphere with a counting shell tally
    (tests/test_torch_cuda.py holds the same plans at 2**16 x 64)."""
    c_dt = L / 64
    a_s = 0.05 / c_dt
    box = ((0.0, L),) * 3
    h = L / 2

    def plan(ops, n_rec, n_f=0, n_stream=0, every=1, dtype="float32"):
        return F.FusedPlan(ops=ops, n_rec_cols=n_rec, chunk=chunk,
                           const_norm_speed=C_LIGHT, n_frec_cols=n_f,
                           n_stream=n_stream, stream_every=every,
                           stream_dtype=dtype)

    iso = F._Op("iso", coef=a_s, c_val=C_LIGHT)
    return {
        "geom-reflect-trace-f32-dv": plan([
            F._Op("kin"), iso, F._Op("reflect", bounds=box),
            F._Op("trace", stream0=0, stream_scat=True)], 1, n_stream=4),
        "geom-periodic-trace-bf16-every4": plan([
            F._Op("kin"), iso, F._Op("periodic", bounds=box),
            F._Op("trace", stream0=0, stream_every=4)], 1, n_stream=3,
            every=4, dtype="bfloat16"),
        "geom-del-scross-w-sabsorb-in-cross-ecap": plan([
            F._Op("kin"), iso, F._Op("del", coef=0.01 / c_dt),
            F._Op("scross", sphere=(h, h, h, 0.3 * L), cols=(1, 0),
                  weighted=True),
            F._Op("sabsorb", sphere=(h, h, h, 0.12 * L), inside=True),
            F._Op("cross", cols=(2,),
                  axes=((0, h + 0.37 * c_dt, 3, -1, 0),))], 4, n_f=1,
            n_stream=1),
        "geom-sabsorb-scross": plan([
            F._Op("kin"), iso,
            F._Op("sabsorb", sphere=(h, h, h, 0.45 * L)),
            F._Op("scross", sphere=(h, h, h, 0.4 * L), cols=(-1, 1))], 2),
    }


def scatter_plans(F, light, chunk, L):
    """One plan per form of the rotation family and the del variants over
    the box [0, L]**3 (c dt = L / 64; ``geometry_packed`` states): HG with
    g = 0.9; Rayleigh with lambda**-4; a Mie phase table (x = 5, 64 bins);
    cold Compton with sigma_KN and the heating tally (alpha = E from 0.5
    to 2 across Kahn and Koblinger); thermal Compton (theta_e = 0.01); the
    refractive plane with and without match_speed behind isotropic
    scattering; the exponential transform with a weighted sign; Fe K-alpha
    fluorescence with an A(E) expression and deposition
    (tests/test_torch_cuda.py holds the same plans at 2**16 x 64)."""
    c_dt = L / 64
    mu, pdf, _ = light.mie_phase_table(5.0)
    loc = L / 2 + 0.37 * c_dt

    def plan(ops, n_f=0, weighted=False, const_norm=True):
        """[kin, *ops, sign]: the ops' float columns first, then the
        weighted sign's three."""
        return F.FusedPlan(
            ops=[F._Op("kin"), *ops,
                 F._Op("sign", cols=(1, n_f if weighted else 2),
                       weighted=weighted)],
            n_rec_cols=2 if weighted else 5, chunk=chunk,
            const_norm_speed=C_LIGHT if const_norm else None,
            n_frec_cols=n_f + (3 if weighted else 0))

    iso = F._Op("iso", coef=0.05 / c_dt, c_val=C_LIGHT)
    return {
        "rot-hg": plan([F._Op("hg", coef=0.1 / c_dt, c_val=C_LIGHT,
                              g=0.9)]),
        # lambda**-4: pcoll = c dt (E wl_base)**4, 0.1 at E = 1
        "rot-rayl-wl": plan([F._Op("rayl", coef=1.0, c_val=C_LIGHT,
                                   wl_base=(0.1 / c_dt) ** 0.25)]),
        "rot-phase-mie": plan([F._Op("phase", coef=0.1 / c_dt, c_val=C_LIGHT,
                                     phase_knots=light.phase_knots(mu, pdf,
                                                                   64))]),
        "rot-compton-kn-dep": plan([F._Op(
            "compton", coef=0.1 / c_dt, c_val=C_LIGHT, inv_mec2=2.0,
            kn_xsec=True, kn_tries=12, cols=(0,))], n_f=1),
        "rot-compton-thermal": plan([F._Op(
            "compton", coef=0.1 / c_dt, c_val=C_LIGHT, inv_mec2=0.02,
            kn_tries=12, theta_e=0.01, cols=(0,))], n_f=1),
        "rot-fresnel": plan([iso, F._Op("fresnel", c_val=C_LIGHT,
                                        iface=(2, loc, 1.0, 1.5, False))],
                            const_norm=False),
        "rot-fresnel-match": plan([iso, F._Op(
            "fresnel", c_val=C_LIGHT, iface=(2, loc, 1.0, 1.5, True))],
            const_norm=False),
        "rot-del-stretch-w": plan([F._Op(
            "del", coef=0.02 / c_dt, stretch=(0.7, 0.6, 0.0, 0.8),
            cols=(0,))], n_f=1, weighted=True),
        "rot-del-fluor-dep": plan([F._Op(
            "del", coef=0.004 / c_dt, c_val=C_LIGHT,
            a_fn=light._compile_field_expr("(2.0 / E[gid])**3", ("E",),
                                           "A_fn"),
            fluor=(0.34, 0.64, 0.711), cols=(0,))], n_f=1),
    }


def lorentz_packed(C, extras, photons, seed):
    """Seeded (15 + len(extras), C) state of a charged (``photons`` = 0),
    photon (1) or mixed (0.5) population: photons at c and E in [0.5, 2],
    charges at speeds in [0.1, 0.5] c (so that an ungated photon op would
    reach them) with E = 0, random directions and positions near the
    origin, ~95% alive; the "otype" plane marks the
    photons, the "qm" plane holds q/m in {-2, -1, 0, 1, 3}."""
    rng = np.random.default_rng(seed)
    p = np.zeros((15 + len(extras), C), np.float32)
    p[0:3] = rng.normal(size=(3, C))
    d = rng.normal(size=(3, C))
    photon = rng.uniform(size=C) < photons
    p[6:9] = d / np.linalg.norm(d, axis=0) * np.where(
        photon, 1.0, rng.uniform(0.1, 0.5, C)) * C_LIGHT
    p[12] = np.where(photon, rng.uniform(0.5, 2.0, C), 0.0)
    p[13] = rng.uniform(size=C) < 0.95
    p[14] = 1.0
    for j, name in enumerate(extras):
        p[15 + j] = (photon if name == "otype"
                     else rng.choice([-2.0, -1.0, 0.0, 1.0, 3.0], C))
    return p


def lorentz_sched(torch, K, dev):
    """A (5, K) schedule whose dt grows from 1e-3 by half over the chunk:
    row 0 (kinematics) and row 3 (after the update) hold dt_k, row 4
    (before the update) dt_(k-1), so a push that took the wrong row would
    differ."""
    dt = 1e-3 * (1.0 + 0.5 * torch.arange(K, dtype=torch.float64) / K)
    s = torch.zeros((5, K), dtype=torch.float32)
    s[0] = s[3] = dt
    s[4, 0] = 1e-3
    s[4, 1:] = dt[:-1]
    return s.to(dev)


def lorentz_plans(F, chunk):
    """One plan per form of the Boris push and of the mixed population,
    each ``(plan, photon share of lorentz_packed)``: a species-wide q/m in
    E and B; per-particle q/m (the "qm" plane) in B; the photon
    population's q/m = 0 no-op before scattering; the push before the
    update (schedule row 4); a mixed population's push, scattering and
    absorption; and the same with an emitter filling the upper half of the
    slots, per-particle q/m and an E field (tests/test_torch_cuda.py holds
    the same plans at 2**16 x 64)."""
    from physicl_tpu_torch.state import OBJ_GENERIC, OBJ_PHOTON

    c_dt = C_LIGHT * 1e-3
    EB = {"e_const": (4.0, 0.0, 0.0), "b_const": (0.0, 0.0, 200.0)}

    def plan(ops, species=OBJ_GENERIC, extras=()):
        return F.FusedPlan(ops=[*ops, F._Op("sign", cols=(1, 2))],
                           n_rec_cols=5, chunk=chunk, species=species,
                           extras=extras)

    def lor(**kw):
        return F._Op("lorentz", **kw)

    kin = F._Op("kin")
    iso = F._Op("iso", coef=0.05 / c_dt, c_val=C_LIGHT)
    dele = F._Op("del", coef=0.002 / c_dt)
    emit = F._Op("emit", emit_n=2048, emit_E=1.0, c_val=C_LIGHT)
    mixed = F.SPECIES_MIXED
    return {
        "lor-species-EB": (plan([lor(qm=-1.5, **EB), kin]), 0.0),
        "lor-qm-B": (plan([lor(qm_plane=15, b_const=(0.3, -0.1, 200.0)),
                           kin], extras=("qm",)), 0.0),
        "lor-photon-noop": (plan([lor(), kin, iso], species=OBJ_PHOTON),
                            1.0),
        "lor-before-update": (plan([lor(qm=2.0, after_update=False, **EB),
                                    kin]), 0.0),
        "mixed": (plan([lor(qm=1.0, b_const=(0.0, 0.0, 200.0)), kin, iso,
                        dele], species=mixed, extras=("otype",)), 0.5),
        "mixed-emit-qm": (plan([emit, lor(qm_plane=16, **EB), kin, iso,
                                dele], species=mixed,
                               extras=("otype", "qm")), 0.5),
    }


def lorentz_inputs(torch, plan, photons, C, K, dev, seed):
    """(packed, sched, emit starts or None) for a ``lorentz_plans`` plan;
    an emitter's plan gets the upper half of the slots dead and generic,
    filled from C / 2 at its rate."""
    p = lorentz_packed(C, plan.extras, photons, seed)
    starts = None
    if plan.n_emit:
        p[13, C // 2:] = 0.0
        p[15 + plan.extras.index("otype"), C // 2:] = 0.0
        n = plan.ops[0].emit_n
        starts = torch.full((1, K), -(2 ** 30), dtype=torch.int32)
        fits = min(K, (C - C // 2) // n)
        starts[0, :fits] = C // 2 + n * torch.arange(fits,
                                                     dtype=torch.int32)
        starts = starts.to(dev)
    return torch.from_numpy(p).to(dev), lorentz_sched(torch, K, dev), starts


def stream_equal(a, b):
    """Stream buffers equal bit for bit, every NaN mapped to one pattern
    (``torch.equal`` is False wherever either side holds a NaN)."""
    import torch

    width = torch.int16 if a.element_size() == 2 else torch.int32

    def bits(x):
        return torch.where(torch.isnan(x), float("nan"), x).view(width)
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(bits(a), bits(b)))


def stream_bytes(plan, slots):
    """Bytes of one launch's stream buffer."""
    elem = 2 if plan.stream_dtype == "bfloat16" else 4
    return plan.n_stream_rows * plan.n_stream * slots * elem


def bf16_bins(torch, L, n):
    """Edges of n bins over [0, L] on the bfloat16 grid (the values nearest
    j L / n, j = 1 .. n-1) and each bin's share of a uniform [0, L] once
    rounded to nearest-even bfloat16: a value rounds up to an edge from
    half-way below it."""
    e = torch.tensor([j * L / n for j in range(1, n)]).to(torch.bfloat16)
    below = (e.view(torch.int16) - 1).view(torch.bfloat16)
    e, below = e.double().numpy(), below.double().numpy()
    bounds = np.concatenate([[0.0], (e + below) / 2, [L]])
    return e, np.diff(bounds) / L


def isotropic_v(torch, n, c, gen, dev):
    """(3, n) float32 directions uniform on the sphere, at speed c."""
    d = torch.randn((3, n), generator=gen, device=dev)
    return d / torch.linalg.vector_norm(d, dim=0) * c


def escape_sim(phys, sampler, n, dev, seed=17, absorb=True, trace=False,
               radius=ESC_R):
    """Path A, escape flux and spectrum from a scattering sphere: n photons
    from r = 0, isotropic at c, Planck energies from ``sample_device``;
    UpdateTime, kinematics, isotropic scattering (A n c dt = 0.05),
    absorption (p = 1e-3 per iteration), a plane at x = R/2 capturing the
    crossing photons' energies (list mode), the shell tally at R and the
    escape sphere R = 32 c dt (``radius``, in c dt); 1024 iterations.
    ``absorb=False`` drops the absorption; ``trace`` adds an unstrided
    float32 trace held on the card. Returns ``(sim, plane tally, shell
    tally, trace or None)``."""
    import torch

    light = phys.light
    c_dt = float(light.c) * ESC_DT
    R = radius * c_dt
    sim = phys.Simulation(until_t=(ESC_ITERS - 0.5) * ESC_DT, seed=seed,
                          device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(ESC_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterIsotropicStep(A=ESC_SCATTER / c_dt, n=1.0))
    if absorb:
        sim.add_step(3, light.ScatterDeleteStep(1.0, ESC_ABSORB / c_dt))
    plane = light.ScatterMeasureStep(None, True, [(R / 2, np.nan, np.nan)],
                                     measure_E=True)
    sim.add_step(4, plane)
    shell = light.SphericalShellMeasureStep(radius=R)
    sim.add_step(5, shell)
    sim.add_step(6, phys.newton.AbsorbingSphereStep(R))
    tr = None
    if trace:
        tr = light.TracePathMeasureStep(None)
        tr.device_hold_bytes = 1 << 36  # keep every chunk on the card
        sim.add_step(7, tr)
    E0 = sampler.sample_device(seed, n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = isotropic_v(torch, n, float(light.c), gen, dev)
    sim.add_photons(light.generate_photon_state(n, E=E0, v=v, device=dev))
    return sim, plane, shell, tr


def cavity_sim(phys, n, dev, seed=29, iters=CAV_ITERS, every=CAV_EVERY,
               dtype="bfloat16", hold=CAV_HOLD):
    """Path B, traced diffusion in a closed cavity: n photons uniform in
    [0, L]**3 (L = 64 c dt), isotropic at c; UpdateTime, kinematics, the
    reflecting box, isotropic scattering with pcoll = 0.3, and a trace
    every ``every`` iterations in ``dtype`` with ``device_hold_bytes =
    hold``. Returns ``(sim, trace)``."""
    import torch

    light = phys.light
    c_dt = float(light.c) * CAV_DT
    L = CAV_L * c_dt
    sim = phys.Simulation(until_t=(iters - 0.5) * CAV_DT, seed=seed,
                          device=dev)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(CAV_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, phys.newton.ReflectingBoundaryStep(((0.0, L),) * 3))
    sim.add_step(3, light.ScatterIsotropicStep(A=CAV_PCOLL / c_dt, n=1.0))
    tr = light.TracePathMeasureStep(None, trace_every=every,
                                    trace_dtype=dtype)
    tr.device_hold_bytes = hold
    sim.add_step(4, tr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = torch.rand((3, n), generator=gen, device=dev) * L
    v = isotropic_v(torch, n, float(light.c), gen, dev)
    sim.add_photons(light.generate_photon_state(n, E=1.0, r=r, v=v,
                                                device=dev))
    return sim, tr


def path_chunk0(name, sim, F, torch, compare, path, card, kinds,
                streams=True, cross_p=0.0, grids=None, twin_iters=None):
    """Phase: fused_transport against the twin on a path's first chunk, as
    its provider hands it over; returns the kernel's entry numbers (and
    stores the launch's grid in ``grids[path]`` when given). The bound
    counts the rotation family's work per expected event
    (``expected_events``, interface crossings at ``cross_p`` per
    photon-iteration). ``twin_iters`` holds the kernel against the twin on
    the chunk's first that many iterations only (same inputs; the kernel
    is still timed on the whole chunk), where the twin takes over a
    minute: ``plain_ms`` is then the twin's time for those iterations, and
    the entry says how many (``plain_iters``)."""
    phase(f"fused_transport vs twin on the {path} path's first chunk")
    packed, sched, seed, k, plan, _ = first_chunk_inputs(sim, F)
    del sim
    check([op.kind for op in plan.ops] == kinds
          and bool(plan.n_stream) == streams
          and (not plan.has_pol or plan.extras[:6] == F.POL_ROWS),
          f"{name}: plan {[op.kind for op in plan.ops]} (extras "
          f"{plan.extras}) is not the path's")
    grid = F.kernel_grid(plan, packed.shape[1], k)
    if grids is not None:
        grids[path] = grid
    print(f"{name}: {packed.shape[1]} slots x {k} iterations, ops "
          f"{[op.kind for op in plan.ops]}, {plan.n_rec_cols} int + "
          f"{plan.n_frec_cols} float record columns, const-norm "
          f"{plan.const_norm_speed is not None}; variant "
          f"{plan.kernel_variant} ({kernel_regs(plan.kernel_variant, plan)}"
          "); grid "
          f"{grid} blocks ({grid / 132:.2f} per SM); stream {plan.n_stream} planes "
          f"every {plan.stream_every} in {plan.stream_dtype}, "
          f"{plan.n_stream_rows} rows = {stream_bytes(plan, packed.shape[1])}"
          " B per chunk", flush=True)
    if plan.has_user:
        print(f"{name}: {user_report(F, plan, packed.shape[1], k)} [{card}]",
              flush=True)
    kc = min(k, twin_iters or k)
    out = {"plain_ms": compare(name, packed, sched, kc, plan, None, path,
                               seed, need_bitwise=True)}
    if kc < k:
        out["plain_iters"] = kc
    res = torch.empty_like(packed)
    rec = F.fused_transport(packed, res, sched, seed, k, plan)[0]
    events = expected_events(plan, packed, float(rec[:k, 0].double().sum()),
                             float(sched[0, 0]), cross_p)
    out["ms"] = cuda_ms(lambda: F.fused_transport(packed, res, sched, seed,
                                                  k, plan), 3, torch)
    out["bound_ms"], out["bound_by"] = transport_bound(
        plan, packed.shape[1], k, None, events)
    terms = bound_terms(*transport_counts(plan, packed.shape[1], k, None,
                                          events))
    print(f"{name}: kernel {out['ms']:.2f} ms, twin {out['plain_ms']:.1f} "
          f"ms, bound {out['bound_ms']:.2f} ms ({out['bound_by']}; ms per "
          "term: " + ", ".join(f"{t} {v:.2f}" for t, v in terms.items())
          + f") per chunk [{card}]", flush=True)
    return out


def run_sim(torch, sim, profile=False):
    """start() and join() ``sim``; returns ``(wall s, profiler or None,
    peak bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        prof = prof_ctx(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    sim.start()
    sim.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    return wall, prof, torch.cuda.max_memory_allocated()


def steady_rate(sim, per_iter):
    """Photon-steps/s over the dispatch loop after the first chunk, on the
    device's clock; ``per_iter`` is the photons each iteration carried."""
    first_done, last_done = sim.chunk_log[0][2], sim.chunk_log[-1][2]
    n0 = sim.chunk_log[0][1]
    steady_s = first_done.elapsed_time(last_done) * 1e-3
    return float(np.sum(per_iter[n0:])) / steady_s, steady_s


def escape_path(torch, phys, F, sampler, dev, card, eft, light):
    """Phase: path A through ``Simulation`` at 10**7 photons (twice, the
    second profiled), then the photon balance at 2**20 photons without
    absorption; returns the first run's launch count."""
    phase(f"escape path: {ESC_N} photons, Planck energies, R = {ESC_R} c "
          f"dt, {ESC_ITERS} iterations")

    def run(profile):
        F.fused_transport.launches = 0
        t0 = time.perf_counter()
        sim, plane, shell, _ = escape_sim(phys, sampler, ESC_N, torch.device(
            dev))
        torch.cuda.synchronize()
        t_pop = time.perf_counter() - t0
        wall, prof, peak = run_sim(torch, sim, profile)
        return (sim, plane, shell, wall, t_pop, prof, peak,
                F.fused_transport.launches)

    sim, plane, shell, wall, t_pop, _, peak, launches = run(False)
    print(sim.explain_plan())
    check(sim.used_fused and launches >= 19,
          f"escape path: {launches} kernel launches")
    chunks = [n for _, n, _ in sim.chunk_log]
    check(len(sim.ts) == ESC_ITERS and sum(chunks) == ESC_ITERS
          and len(plane.data) == ESC_ITERS and len(shell.data) == ESC_ITERS,
          f"escape path: {len(sim.ts)} iterations, chunks {chunks}")
    counts = np.array([int(r[2]) for r in plane.data])
    lens = np.array([len(r[3]) for r in plane.data])
    check(np.array_equal(counts, lens), "escape path: an energy list is not "
          "as long as its count column")
    E = np.concatenate([np.asarray(r[3], np.float64) for r in plane.data])
    spec = density_check(E, light, SPECTRUM_TOL)
    alive = np.array([int(r[1]) for r in shell.data])
    esc = np.array([int(r[2]) for r in shell.data])
    check(ESC_N * 0.99 < alive[0] < ESC_N and alive[-1] < alive[0]
          and esc.sum() > 0,
          f"escape path: alive {alive[0]} .. {alive[-1]}, escapes "
          f"{esc.sum()}")
    rate, steady_s = steady_rate(sim, alive)
    print(f"escape path: chunks of {chunks[0]} ({len(chunks)} dispatches), "
          f"fused_transport launches {launches}; {len(E)} listed energies "
          f"(each iteration's list as long as its count), spectrum within "
          f"{spec:.4f} of the Planck density; shell crossings {esc.sum()}, "
          f"alive {alive[0]} -> {alive[-1]}")
    slot_rate = sim.sim_state.capacity * sum(chunks[1:]) / steady_s
    print(f"escape path rate: {rate:.4e} alive photon-steps/s "
          f"({slot_rate:.4e} slot-steps/s) over the dispatch loop after the "
          f"first chunk, device clock ({steady_s * 1e3:.1f} ms); "
          f"{alive.sum() / wall:.4e} from start() "
          f"({wall:.3f} s wall); set-up {sim.setup_seconds:.3f} s in start()"
          f" + {t_pop * 1e3:.1f} ms sample_device and generate_photon_state; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; kernel {eft['ms']:.2f} ms "
          f"per chunk against a bound of {eft['bound_ms']:.2f} ms "
          f"({eft['bound_by']}) [{card}]", flush=True)
    rows = [(r[1], r[2], r[3]) for r in plane.data]
    shell_rows = np.asarray(shell.data)
    out = {"fused_launches": launches}
    del sim, plane, shell, E

    sim2, plane2, shell2, _, _, prof, _, _ = run(True)
    check(rows == [(r[1], r[2], r[3]) for r in plane2.data]
          and np.array_equal(shell_rows, np.asarray(shell2.data)),
          "escape path: a second run with the same seed gave other tallies "
          "or energy lists")
    busy, span = device_busy(prof, torch)
    print(f"escape path device idle share (profiled second run, first to "
          f"last fused_transport kernel, list compaction included): "
          f"{1 - busy / span:.4f} ({busy:.1f} ms busy of {span:.1f} ms) "
          f"[{card}]")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10))
    del sim2, plane2, shell2, prof, rows

    # photon balance: every escape is one outward shell crossing, except
    # at the seam, where the kernel's float32 r**2 lands on R**2 (counted
    # without dying, so counted again when the photon moves on) or within
    # rounding of it (r - dr is recomputed, so a crossing can be missed).
    # Photons from r = 0 that have not scattered land on the c dt lattice,
    # at R = 32 c dt; the run is repeated off the lattice, where the seam
    # is rare and the balance tight
    for radius in (ESC_R, ESC_R + 0.37):
        phase(f"escape path photon balance: {ESC_CLOSURE_N} photons without "
              f"absorption, traced, R = {radius} c dt")
        sim, _, shell, tr = escape_sim(phys, sampler, ESC_CLOSURE_N,
                                       torch.device(dev), seed=23,
                                       absorb=False, trace=True,
                                       radius=radius)
        run_sim(torch, sim)
        esc = int(np.asarray(shell.data)[:, 2].sum())
        died = ESC_CLOSURE_N - int(sim.sim_state.n_alive)
        R = np.float32(radius * float(light.c) * ESC_DT)
        R2 = R * R
        seam_d = 64 * float(np.spacing(R2))
        on_sphere = seam = 0
        for x in tr._pos:
            b = x.buf[:-(-x.n_valid // x.every), x.p0:x.p0 + 3]
            # the kernel's float32 r**2 (centre 0), summed left to right
            r2 = b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1] + b[:, 2] * b[:, 2]
            on_sphere += int((r2 == float(R2)).sum())
            seam += int(((r2 - float(R2)).abs() <= seam_d).sum())
        balance = esc - died
        check(abs(balance) <= 2 * seam,
              f"photon balance at R = {radius} c dt: {esc} shell crossings "
              f"for {died} escapes, {seam} landings at the seam")
        print(f"escape path balance, R = {radius} c dt: N0 {ESC_CLOSURE_N} "
              f"= alive {ESC_CLOSURE_N - died} + escapes {died}; shell "
              f"crossings {esc} = escapes {balance:+d}; landings exactly on "
              f"r**2 = R**2: {on_sphere}, within 64 ulp of it: {seam}",
              flush=True)
        del sim, shell, tr
    return out


def cavity_path(torch, phys, F, dev, card, cft):
    """Phase: path B through ``Simulation`` at 10**6 photons (twice, the
    second profiled), then the bfloat16 stride-8 trace against the float32
    unstrided one at 10**5 photons; returns the first run's launches."""
    phase(f"cavity path: {CAV_N} photons, reflecting box of {CAV_L} c dt, "
          f"{CAV_ITERS} iterations traced every {CAV_EVERY} in bfloat16")
    light = phys.light
    L = CAV_L * float(light.c) * CAV_DT

    def run(profile):
        F.fused_transport.launches = 0
        sim, tr = cavity_sim(phys, CAV_N, torch.device(dev))
        wall, prof, peak = run_sim(torch, sim, profile)
        return sim, tr, wall, prof, peak, F.fused_transport.launches

    sim, tr, wall, _, peak, launches = run(False)
    print(sim.explain_plan())
    chunks = [n for _, n, _ in sim.chunk_log]
    check(sim.used_fused and launches >= 2 and chunks[:2] == [1024, 1024],
          f"cavity path: launches {launches}, chunks {chunks}")
    check("const-norm |dr| = c*dt: off" in sim.plan_report.notes,
          "cavity path: a reflection before scattering must turn the "
          "const-norm path off")
    spilled = [isinstance(x.buf, np.ndarray) for x in tr._pos]
    check(spilled[0] and not spilled[-1], f"cavity path: spills {spilled}")
    st = sim.sim_state
    speed = torch.linalg.vector_norm(st.v[:, :CAV_N].double(), dim=0)
    v_err = float((speed / float(light.c) - 1).abs().max())
    check(v_err < 1e-6, f"cavity path: |v| off c by {v_err:.2e}")
    t_arrays = time.perf_counter()
    ts, pos, alive, _ = tr.as_arrays()
    t_arrays = time.perf_counter() - t_arrays
    C = st.capacity
    check(pos.shape == (CAV_ITERS // CAV_EVERY, 3, C)
          and ts == list(np.asarray(sim.ts)[::CAV_EVERY]),
          f"cavity path: as_arrays {pos.shape}, {len(ts)} sampled times")
    inside = pos[:, :, :CAV_N]
    check(bool(alive[:, :CAV_N].all()) and not alive[:, CAV_N:].any(),
          "cavity path: alive rows wrong")
    lo, hi = float(inside.min()), float(inside.max())
    check(lo >= 0.0 and hi <= L * (1 + 2.0 ** -8),
          f"cavity path: traced positions [{lo}, {hi}] leave [0, {L}] (by "
          "more than a bfloat16 rounding)")
    # 16 bins with edges on the bfloat16 grid, each expected to hold the
    # share of a uniform [0, L] that rounds into it. The two bins at the
    # walls hold fewer: a photon folded by a wall has |dr| < c dt in that
    # iteration, and its collision probability is A n |dr| (the JAX
    # package's semantics, const-norm off), so it keeps its inward
    # direction more often. They are held to 5% and printed.
    edges, share = bf16_bins(torch, L, 16)
    worst, wall_dev = 0.0, []
    for d in range(3):
        h = np.bincount(np.searchsorted(edges, inside[-1, d], side="right"),
                        minlength=16)
        z = (h - CAV_N * share) / np.sqrt(CAV_N * share * (1 - share))
        worst = max(worst, float(np.abs(z[1:-1]).max()))
        wall_dev += [float(h[i] / (CAV_N * share[i]) - 1) for i in (0, 15)]
    check(worst <= 5.0 and max(abs(w) for w in wall_dev) < 0.05,
          f"cavity path: last row not flat ({worst:.2f} sigma inside, "
          f"walls {wall_dev})")
    rate, steady_s = steady_rate(sim, np.full(len(sim.ts), CAV_N))
    print(f"cavity path: chunks {chunks}, fused_transport launches "
          f"{launches}; chunk 0 spilled to host; as_arrays {pos.shape} in "
          f"{t_arrays:.2f} s; positions in [{lo:.6g}, {hi:.6g}] (box "
          f"{L:.6g}); last row's x/y/z histograms flat within {worst:.2f} "
          "binomial sigma on the 14 inner bins, the wall bins off flat by "
          + ", ".join(f"{w:+.4f}" for w in wall_dev)
          + f"; |v| = c within {v_err:.2e}")
    print(f"cavity path rate: {rate:.4e} photon-steps/s over the dispatch "
          f"loop after the first chunk, device clock ({steady_s * 1e3:.1f} "
          f"ms); {CAV_N * len(sim.ts) / wall:.4e} from start() ({wall:.3f} s "
          f"wall); set-up {sim.setup_seconds:.3f} s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; kernel {cft['ms']:.2f} ms per chunk "
          f"against a bound of {cft['bound_ms']:.2f} ms ({cft['bound_by']}) "
          f"[{card}]", flush=True)
    last = pos[-1].copy()
    final = F.pack_state(st).clone()
    out = {"fused_launches": launches}
    del sim, tr, st, pos, alive, inside

    sim2, tr2, _, prof, _, _ = run(True)
    check(torch.equal(F.pack_state(sim2.sim_state), final)
          and np.array_equal(tr2.as_arrays()[1][-1], last, equal_nan=True),
          "cavity path: a second run with the same seed differs")
    busy, span = device_busy(prof, torch)
    print(f"cavity path device idle share (profiled second run, first to "
          f"last fused_transport kernel, the spill included): "
          f"{1 - busy / span:.4f} ({busy:.1f} ms busy of {span:.1f} ms) "
          f"[{card}]")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8))
    del sim2, tr2, final, prof

    phase("cavity path: bfloat16 every 8 against float32 every iteration "
          "(10**5 photons, 256 iterations)")
    arrays = {}
    for every, dtype in ((1, "float32"), (CAV_EVERY, "bfloat16")):
        sim, tr = cavity_sim(phys, 100_000, torch.device(dev), iters=256,
                             every=every, dtype=dtype, hold=1 << 36)
        run_sim(torch, sim)
        arrays[dtype] = tr.as_arrays()[1]
    want = torch.from_numpy(arrays["float32"][::CAV_EVERY]).to(
        torch.bfloat16).float().numpy()
    check(arrays["bfloat16"].shape == want.shape
          and np.array_equal(arrays["bfloat16"], want, equal_nan=True),
          "cavity path: the bfloat16 stride-8 trace is not the rounded "
          "float32 trace")
    print(f"cavity path: bfloat16 stride-{CAV_EVERY} trace "
          f"{arrays['bfloat16'].shape} == round-to-nearest-even of the "
          "float32 trace's every 8th row, bitwise", flush=True)
    return out


def geometry_card_vs_cpu(torch, phys, F, sampler, err):
    """Phase: small Simulations with every new step on the card and on the
    CPU twin: a scattering, absorbing reflecting box with two energy-list
    planes, a weighted shell tally and a traced path with scatter flags;
    a periodic box with a central absorber, a counting shell tally and a
    bfloat16 trace every 4th iteration."""
    phase("stream and geometry Simulations on the card against the CPU twin "
          "(2**16 photons)")
    light = phys.light
    c_dt = float(light.c) * 0.001
    L = 24 * c_dt
    h = L / 2
    n = 1 << 16
    for case in ("reflect", "periodic"):
        runs = {}
        for where in ("cuda", "cpu"):
            sim = phys.Simulation(until_t=0.0475, seed=8, chunk_steps=16,
                                  device=where)
            sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
            sim.add_step(1, phys.newton.NewtonianKinematicsStep())
            sim.add_step(2, light.ScatterIsotropicStep(A=0.1 / c_dt, n=1.0))
            if case == "reflect":
                sim.add_step(3, light.ScatterDeleteStep(1.0, 0.01 / c_dt))
                sim.add_step(4, phys.newton.ReflectingBoundaryStep(
                    ((0.0, L),) * 3))
                tally = light.ScatterMeasureStep(
                    None, True, [(h + 0.37 * c_dt, np.nan, np.nan),
                                 (np.nan, 0.3 * L, np.nan)], measure_E=True)
                shell = light.SphericalShellMeasureStep(
                    radius=0.31 * L, center=(h, h, h), weighted=True)
                tr = light.TracePathMeasureStep(None, trace_dv=True)
            else:
                sim.add_step(4, phys.newton.PeriodicBoundaryStep(
                    ((0.0, L),) * 3))
                sim.add_step(3, phys.newton.AbsorbingSphereStep(
                    0.113 * L, center=(h, h, h), kill_inside=True))
                tally = None
                shell = light.SphericalShellMeasureStep(
                    radius=0.383 * L, center=(h, h, h))
                tr = light.TracePathMeasureStep(None, trace_every=4,
                                                trace_dtype="bfloat16")
            if tally is not None:
                sim.add_step(5, tally)
            sim.add_step(6, shell)
            sim.add_step(7, tr)
            rng = np.random.default_rng(4)
            d = rng.normal(size=(3, n))
            sim.add_photons(light.generate_photon_state(
                n, E=sampler.sample_device(3, n, device="cpu"),
                v=d / np.linalg.norm(d, axis=0) * float(light.c),
                r=rng.uniform(0.1, 0.9, (3, n)) * L, device=where))
            sim.start()
            sim.join()
            runs[where] = (sim, tally and tally.data, np.asarray(shell.data),
                           tr.as_arrays())
        (gs, gl, gsh, ga), (cs, cl, csh, ca) = runs["cuda"], runs["cpu"]
        check(gs.ts == cs.ts and len(gs.ts) == 48,
              f"{case}: sim.ts differs between card and CPU")
        if case == "reflect":
            check(np.array_equal(gsh[:, :2], csh[:, :2])
                  and np.allclose(gsh[:, 2], csh[:, 2], rtol=RTOL_F,
                                  atol=0), f"{case}: shell tallies differ")
            check(all(len(a) == len(b) and all(
                (x == y) if not isinstance(y, list) else x == y
                for x, y in zip(a, b)) for a, b in zip(gl, cl)),
                f"{case}: energy lists or counts differ")
            n_listed = sum(len(r[3]) + len(r[5]) for r in gl)
        else:
            check(np.array_equal(gsh, csh), f"{case}: shell counts differ")
            n_listed = 0
        check(ga[0] == ca[0] and np.array_equal(ga[1], ca[1], equal_nan=True)
              and np.array_equal(ga[2], ca[2])
              and (ga[3] is None or np.array_equal(ga[3], ca[3])),
              f"{case}: traces differ between card and CPU")
        print(f"{case} card == CPU: sim.ts, tallies, {n_listed} listed "
              f"energies, trace {ga[1].shape} bitwise (NaN for NaN)",
              flush=True)


def rotation_plans(torch, F, light, dev, seed, compare, card, times):
    """Phase: fused_transport against the twin on the nine rotation-family
    and del-variant plans at 2**20 slots x 256 iterations; each timed with
    its counted bound (collisions at the plans' pcoll, interface crossings
    at c dt / 2 per box side per photon-iteration)."""
    C, K = 1 << 20, 256
    phase(f"fused_transport vs twin on the rotation plans (2**20 slots, {K} "
          "iterations)")
    L = 64 * C_LIGHT * 0.001
    pk = torch.from_numpy(geometry_packed(C, L, 12)).to(dev)
    sched = torch.zeros((5, K), dtype=torch.float32, device=dev)
    sched[0] = 0.001
    for name, plan in scatter_plans(F, light, K, L).items():
        check(plan.kernel_variant & 4, f"{name}: not the rotation variant")
        plain_ms = compare(name, pk, sched, K, plan, None, "rot",
                           need_bitwise=True)
        out = torch.empty_like(pk)
        rec, _ = F.fused_transport(pk, out, sched, seed, K, plan)
        ms = cuda_ms(lambda: F.fused_transport(pk, out, sched, seed, K,
                                               plan), 5, torch)
        steps = float(rec[:K, 0].double().sum())
        events = expected_events(plan, pk, steps, 0.001, cross_p=0.5 / 64)
        b_ms, b_by = transport_bound(plan, C, K, None, events)
        times[name] = ms
        print(f"{name} at 2**20 x {K}: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{sum(events.values()):.4g} counted events) [{card}]",
              flush=True)
    del pk, out


def scatter_once(torch, F, op, n, dev, seed, E=1.0):
    """n photons in isotropic directions at c through one iteration of
    [kin, op] on the kernel: (cos theta of each to its incoming
    direction, the scattered mask (dv != 0), the state after)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = isotropic_v(torch, n, 1.0, gen, dev)
    p = torch.zeros((15, n), dtype=torch.float32, device=dev)
    p[6:9] = d * C_LIGHT
    p[12], p[13], p[14] = E, 1.0, 1.0
    plan = F.FusedPlan(ops=[F._Op("kin"), op], n_rec_cols=1, chunk=1,
                       const_norm_speed=C_LIGHT)
    sched = torch.zeros((5, 1), dtype=torch.float32, device=dev)
    sched[0] = 0.001
    out = torch.empty_like(p)
    F.fused_transport(p, out, sched, seed, 1, plan)
    cos = (out[6:9].double() / C_LIGHT * d.double()).sum(0)
    return cos, (out[9:12] != 0).any(0), out


def kn_bins(alpha, edges):
    """The Klein-Nishina density of eps = E'/E integrated over each bin:
    f(eps) ~ eps + 1/eps - 1 + cos^2 theta, cos theta = 1 - (1/eps - 1) /
    alpha, on [1 / (1 + 2 alpha), 1] (Simpson, normalised)."""
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        x = np.linspace(lo, hi, 201)
        ct = 1 - (1 / x - 1) / alpha
        f = x + 1 / x - 1 + ct * ct
        h = (hi - lo) / 200
        out.append(h / 3 * (f[0] + f[-1] + 4 * f[1:-1:2].sum()
                            + 2 * f[2:-1:2].sum()))
    out = np.asarray(out)
    return out / out.sum()


def physics_gates(torch, F, light, dev, card):
    """Phase: one iteration on the kernel where every photon scatters
    (pcoll >= 1), except the thermal case: HG <cos> = g, Rayleigh <cos^2> =
    2/5, the Mie table's <cos> against its g, the Klein-Nishina E'/E
    histogram against the analytic bin integrals (Kahn at alpha 0.1 and 1,
    Koblinger at 10), the Kompaneets drift of thermal Compton at an
    unsaturated p = 0.3; then the Fresnel reflectance at a single glass ->
    air plane below the critical angle, and total internal reflection
    beyond it."""
    phase("physics gates (2**20 photons, one iteration)")
    n = 1 << 20
    c_dt = C_LIGHT * 0.001
    hit = 2.0 / c_dt  # pcoll = 2: every photon collides
    cos, scat, _ = scatter_once(torch, F, F._Op("hg", coef=hit,
                                                c_val=C_LIGHT, g=0.9),
                                n, dev, 1)
    z = (float(cos.mean()) - 0.9) / (float(cos.std()) / np.sqrt(n))
    check(bool(scat.all()) and abs(z) < 5, f"HG <cos> off g by {z:.2f} sigma")
    print(f"HG g = 0.9: <cos theta> = {float(cos.mean()):.6f} ({z:+.2f} "
          "sigma)")
    cos, scat, _ = scatter_once(torch, F, F._Op("rayl", coef=hit,
                                                c_val=C_LIGHT), n, dev, 2)
    c2 = cos * cos
    z = (float(c2.mean()) - 0.4) / (float(c2.std()) / np.sqrt(n))
    check(bool(scat.all()) and abs(z) < 5,
          f"Rayleigh <cos^2> off 2/5 by {z:.2f} sigma")
    print(f"Rayleigh: <cos^2 theta> = {float(c2.mean()):.6f} ({z:+.2f} "
          "sigma)")
    # 256 knots: the 64-knot table's own mean sits 1.16e-3 below g (the
    # piecewise-linear inverse CDF's bias), 256 knots 1.5e-5
    mu, pdf, g = light.mie_phase_table(5.0)
    cos, scat, _ = scatter_once(
        torch, F, F._Op("phase", coef=hit, c_val=C_LIGHT,
                        phase_knots=light.phase_knots(mu, pdf, 256)),
        4 * n, dev, 3)
    dev_g = float(cos.mean()) - g
    check(bool(scat.all()) and abs(dev_g) < 1e-3,
          f"Mie table <cos> off its g by {dev_g:.2e}")
    print(f"Mie x = 5 (256 knots, 2**22 photons): <cos theta> = "
          f"{float(cos.mean()):.6f}, g = {g:.6f} ({dev_g:+.2e})")
    for alpha in (0.1, 1.0, 10.0):
        _, scat, out = scatter_once(torch, F, F._Op(
            "compton", coef=hit, c_val=C_LIGHT, inv_mec2=alpha,
            kn_tries=12), n, dev, 4)
        eps = out[12][scat].double().cpu().numpy()
        edges = np.linspace(1 / (1 + 2 * alpha), 1.0, 51)
        h = np.histogram(eps, bins=edges)[0]
        want = kn_bins(alpha, edges) * len(eps)
        chi2 = float(((h - want) ** 2 / want).sum()) / 49
        check(chi2 < 2.0 and len(eps) > 0.99 * n,
              f"Klein-Nishina E'/E at alpha {alpha}: chi2/dof {chi2:.2f}, "
              f"{len(eps)} scattered")
        print(f"Klein-Nishina alpha = {alpha} "
              f"({'Koblinger' if alpha > 2.74 else 'Kahn'}): E'/E "
              f"histogram chi2/dof {chi2:.3f} over 50 bins, {len(eps)} of "
              f"{n} scattered")
    for alpha, want, tol in ((1e-9, 0.04, 0.005), (0.04, 0.0, 0.008)):
        _, scat, out = scatter_once(torch, F, F._Op(
            "compton", coef=0.3 / c_dt, c_val=C_LIGHT, inv_mec2=alpha,
            kn_tries=12, theta_e=0.01), n, dev, 5)
        drift = float(out[12][scat].double().mean()) - 1.0
        share = float(scat.double().mean())
        check(abs(drift - want) < tol and 0.25 < share < 0.35,
              f"thermal drift at alpha {alpha}: {drift:.5f} (want {want})")
        print(f"thermal theta_e = 0.01, alpha = {alpha}: <E'/E> - 1 = "
              f"{drift:+.5f} (Kompaneets 4 theta_e - alpha = {want}), "
              f"{share:.4f} scattered")
    for theta in (30.0, 60.0):
        refl, expect = interface_pass(torch, F, dev, theta, 1.5, 1.0, n)
        sigma = np.sqrt(max(expect * (1 - expect), 1e-12) / n)
        check(abs(refl - expect) <= 5 * sigma + 1e-9,
              f"glass -> air at {theta} degrees: reflected {refl:.6f}, "
              f"Fresnel {expect:.6f}")
        print(f"glass -> air at {theta} degrees: reflected share "
              f"{refl:.6f}, Fresnel {expect:.6f}"
              + (" (total internal reflection)" if expect == 1 else ""),
              flush=True)


def fresnel_R(theta_deg, n1, n2):
    """The unpolarised Fresnel reflectance (1 beyond the critical angle)."""
    ci = np.cos(np.deg2rad(theta_deg))
    st2 = (n1 / n2) ** 2 * (1 - ci * ci)
    if st2 > 1:
        return 1.0
    ct = np.sqrt(1 - st2)
    rs = (n1 * ci - n2 * ct) / (n1 * ci + n2 * ct)
    rp = (n1 * ct - n2 * ci) / (n1 * ct + n2 * ci)
    return 0.5 * (rs * rs + rp * rp)


def interface_pass(torch, F, dev, theta, n1, n2, n):
    """n photons in medium n1 meet the plane x = 0 at theta in one
    iteration on the kernel: (reflected share, Fresnel reflectance)."""
    th = np.deg2rad(theta)
    c_dt = C_LIGHT * 0.001
    gen = torch.Generator(device=dev).manual_seed(6)
    p = torch.zeros((15, n), dtype=torch.float32, device=dev)
    # start within one step of the plane, never on it
    p[0] = -(0.01 + 0.98 * torch.rand(n, generator=gen, device=dev)) \
        * np.cos(th) * c_dt
    p[6], p[7] = np.cos(th) * C_LIGHT, np.sin(th) * C_LIGHT
    p[12], p[13], p[14] = 1.0, 1.0, 1.0
    plan = F.FusedPlan(ops=[F._Op("kin"), F._Op(
        "fresnel", c_val=C_LIGHT, iface=(0, 0.0, n1, n2, False))],
        n_rec_cols=1, chunk=1, const_norm_speed=C_LIGHT)
    sched = torch.zeros((5, 1), dtype=torch.float32, device=dev)
    sched[0] = 0.001
    out = torch.empty_like(p)
    F.fused_transport(p, out, sched, 7, 1, plan)
    return float((out[6] < 0).double().mean()), fresnel_R(theta, n1, n2)


GAMMA_N = 10_000_000     # run_all.py's compton_kn_1e7
GAMMA_ITERS = 5 * 1024
GLASS_N = 10_000_000     # examples/make_fresnel_nb.py sweep 1 at 10**7
GLASS_ITERS = 80
GLASS_N_IN = 1.5
GLASS_THICK = 1.6        # slab thickness in c dt
GLASS_THETA = 45.0


def gamma_sim(phys, n, dev, iters=GAMMA_ITERS, seed=0):
    """The gamma-ray path (benchmarks/run_all.py compton_kn_1e7): n photons
    at E = 1 along +x, UpdateTime, kinematics, ScatterCompton(A n c dt =
    1e-3, mec2 = 1, kn_cross_section, measure_deposition), a sign tally;
    chunks of 1024. Returns ``(sim, compton step, sign tally)``."""
    light = phys.light
    c_dt = float(light.c) * 0.001
    sim = phys.Simulation(until_t=(iters - 0.5) * 0.001, seed=seed,
                          chunk_steps=1024, device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    comp = light.ScatterComptonStep(A=0.001 / c_dt, n=1.0, mec2=1.0,
                                    kn_cross_section=True,
                                    measure_deposition=True)
    sim.add_step(2, comp)
    sign = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, sign)
    sim.add_photons(light.generate_photon_state(n, E=1.0, device=dev))
    return sim, comp, sign


def glass_sim(phys, n, dev, seed=19):
    """The glass-slab path (examples/make_fresnel_nb.py sweep 1): n photons
    in air meet a slab of index 1.5 and thickness 1.6 c dt at 45 degrees,
    starting within one step of its face (never on it); two interfaces and two plane
    tallies 12.3 c dt beyond each side; 80 iterations. Returns ``(sim,
    tally)``."""
    import torch

    light = phys.light
    c_dt = float(light.c) * 0.001
    th = np.deg2rad(GLASS_THETA)
    x0, x1 = 0.37 * c_dt, (0.37 + GLASS_THICK) * c_dt
    sim = phys.Simulation(until_t=(GLASS_ITERS - 0.5) * 0.001, seed=seed,
                          device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.RefractiveInterfaceStep(x0, 1.0, GLASS_N_IN,
                                                  axis=0))
    sim.add_step(3, light.RefractiveInterfaceStep(x1, GLASS_N_IN, 1.0,
                                                  axis=0))
    tally = light.ScatterMeasureStep(
        None, True, [(x1 + 12.3 * c_dt, np.nan, np.nan),
                     (x0 - 12.3 * c_dt, np.nan, np.nan)])
    sim.add_step(4, tally)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = torch.zeros((3, n), dtype=torch.float64, device=dev)
    r[0] = x0 - (0.01 + 0.98 * torch.rand(
        n, generator=gen, dtype=torch.float64, device=dev)) \
        * np.cos(th) * c_dt
    r[1] = torch.rand(n, generator=gen, dtype=torch.float64,
                      device=dev) * 100 * c_dt
    sim.add_photons(light.generate_photon_state(
        n, E=1.0, r=r, v=(np.cos(th) * C_LIGHT, np.sin(th) * C_LIGHT, 0.0),
        device=dev))
    return sim, tally


def run_all_sim(phys, case, n, dev, iters):
    """benchmarks/run_all.py's comptonization_thermal_1e7 and
    exponential_transform_1e7 (n photons at E = 1 along +x, A n c dt =
    1e-3; thermal: mec2 = 1e9, theta_e = 0.01 and a sign tally; stretch:
    the transform b = 0.7 along +x and a weighted sign tally), and the Fe
    K-alpha fluorescence of examples/make_fluorescence_nb.py (E0 = 20,
    p(E0) = 0.004, A(E) = (20 / E)**3 as a C expression, Y = 0.34, the line
    at 6.40 and the edge at 7.11, deposition); ``iters`` iterations.
    Returns ``(sim, {name: step})``."""
    light = phys.light
    c_dt = float(light.c) * 0.001
    sim = phys.Simulation(until_t=(iters - 0.5) * 0.001, seed=0,
                          device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    steps, E0 = {}, 1.0
    if case == "thermal":
        sim.add_step(2, light.ScatterComptonStep(
            A=0.001 / c_dt, n=1.0, mec2=1e9, theta_e=0.01))
        steps["sign"] = light.ScatterSignMeasureStep(None, True)
    elif case == "stretch":
        sim.add_step(2, light.ScatterDeleteStep(1.0, 0.001 / c_dt,
                                                stretch=0.7))
        steps["sign"] = light.ScatterSignMeasureStep(None, True,
                                                     weighted=True)
    else:
        E0 = FLUOR_E0
        steps["dep"] = light.ScatterDeleteStep(
            n=1.0, A=FLUOR_P / c_dt, A_fn="(20.0 / E[gid])**3",
            fluorescence=(FLUOR_Y, FLUOR_KA), fluorescence_edge=7.11,
            measure_deposition=True)
    sim.add_step(3, steps.get("dep") or steps["sign"])
    sim.add_photons(light.generate_photon_state(n, E=E0, device=dev))
    return sim, steps


FLUOR_E0, FLUOR_KA, FLUOR_Y, FLUOR_P = 20.0, 6.40, 0.34, 0.004
RUN_ALL_N = 10_000_000
FLUOR_K = 40             # the example's iterations


def gamma_path(torch, phys, F, dev, card, gft):
    """Phase: the gamma-ray path through Simulation at 10**7 photons (run
    twice, the second profiled): the energy balance, the rates, the idle
    share and the peak memory; returns the first run's launches."""
    phase(f"gamma path: {GAMMA_N} photons, Compton with sigma_KN and "
          f"deposition, {GAMMA_ITERS} iterations")

    def run(profile):
        F.fused_transport.launches = 0
        sim, comp, sign = gamma_sim(phys, GAMMA_N, torch.device(dev))
        wall, prof, peak = run_sim(torch, sim, profile)
        return sim, comp, sign, wall, prof, peak, F.fused_transport.launches

    sim, comp, sign, wall, _, peak, launches = run(False)
    print(sim.explain_plan())
    chunks = [n for _, n, _ in sim.chunk_log]
    check(sim.used_fused and launches >= 5 and chunks[:5] == [1024] * 5,
          f"gamma path: launches {launches}, chunks {chunks}")
    dep = np.asarray(comp.data, np.float64)
    data = np.asarray(sign.data)
    check(dep.shape == (GAMMA_ITERS, 2) and bool((data[:, 1] == GAMMA_N)
                                                 .all()),
          "gamma path: records or photon count wrong")
    st = sim.sim_state
    E = st.E[st.alive].double()
    check(bool(torch.isfinite(E).all() and (E > 0).all() and (E <= 1).all()),
          "gamma path: energies outside (0, 1]")
    balance = (dep[:, 1].sum() + float(E.sum())) / GAMMA_N - 1
    check(abs(balance) < 1e-5, f"gamma path: deposits + sum E off N E0 by "
          f"{balance:.3e}")
    speed = torch.linalg.vector_norm(st.v[:, :GAMMA_N].double(), dim=0)
    v_err = float((speed / C_LIGHT - 1).abs().max())
    check(v_err < 1e-5, f"gamma path: |v| off c by {v_err:.2e}")
    rate, steady_s = steady_rate(sim, np.full(len(sim.ts), GAMMA_N))
    print(f"gamma path: {len(sim.ts)} iterations in chunks {chunks}, "
          f"fused_transport launches {launches}; deposits + sum E = N E0 "
          f"within {balance:+.3e}; mean E {float(E.mean()):.6f}; |v| = c "
          f"within {v_err:.2e}")
    print(f"gamma path rate: {rate:.4e} photon-steps/s over the dispatch "
          f"loop after the first chunk, device clock ({steady_s * 1e3:.1f} "
          f"ms); {GAMMA_N * len(sim.ts) / wall:.4e} from start() "
          f"({wall:.3f} s wall); set-up {sim.setup_seconds:.3f} s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB; kernel {gft['ms']:.2f} ms per "
          f"chunk against a bound of {gft['bound_ms']:.2f} ms "
          f"({gft['bound_by']}) [{card}]", flush=True)
    out = {"fused_launches": launches}
    del sim, st, E, speed
    sim2, comp2, _, _, prof, _, _ = run(True)
    check(np.array_equal(dep, np.asarray(comp2.data, np.float64)),
          "gamma path: a second run with the same seed gave other deposits")
    busy, span = device_busy(prof, torch)
    print(f"gamma path device idle share (profiled second run, first to last "
          f"fused_transport kernel): {1 - busy / span:.4f} ({busy:.1f} ms "
          f"busy of {span:.1f} ms) [{card}]")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=6))
    del sim2, prof
    return out


def glass_path(torch, phys, F, dev, card, sft):
    """Phase: the glass slab through Simulation at 10**7 photons: every
    photon ends transmitted or reflected (to 1e-5 of N: a photon landing
    exactly on a tally plane is counted twice), and the transmission is
    the incoherent slab's (1 - R) / (1 + R) within 5 binomial sigma."""
    phase(f"glass-slab path: {GLASS_N} photons, n = {GLASS_N_IN}, "
          f"{GLASS_THICK} c dt thick, {GLASS_THETA} degrees, {GLASS_ITERS} "
          "iterations")
    F.fused_transport.launches = 0
    sim, tally = glass_sim(phys, GLASS_N, torch.device(dev))
    wall, _, peak = run_sim(torch, sim)
    launches = F.fused_transport.launches
    print(sim.explain_plan())
    data = np.asarray(tally.data)
    check(sim.used_fused and launches >= 1 and data.shape[0] == GLASS_ITERS,
          f"glass path: launches {launches}, rows {data.shape}")
    trans, refl = int(data[:, 2].sum()), int(data[:, 3].sum())
    R = fresnel_R(GLASS_THETA, 1.0, GLASS_N_IN)
    T = (1 - R) / (1 + R)
    t_meas = trans / GLASS_N
    sigma = np.sqrt(T * (1 - T) / GLASS_N)
    # photons left in the slab, less those counted twice: a photon that
    # lands exactly on a tally plane is counted as it lands and as it
    # leaves (the endpoint-inclusive test); both are rare
    left = GLASS_N - trans - refl
    check(abs(t_meas - T) <= 5 * sigma and abs(left) <= 1e-5 * GLASS_N,
          f"glass path: transmission {t_meas:.6f} against (1 - R) / (1 + R) "
          f"= {T:.6f}, {left} photons unaccounted")
    print(f"glass path: transmitted {trans}, reflected {refl}, N less both "
          f"{left}; T = {t_meas:.6f} against (1 - R) / (1 + R) = {T:.6f} "
          f"({(t_meas - T) / sigma:+.2f} sigma), R = {R:.6f}; "
          f"{GLASS_N * len(sim.ts) / wall:.4e} photon-steps/s from start() "
          f"({wall:.3f} s wall, one chunk); peak memory "
          f"{peak / 2 ** 30:.2f} GiB; kernel {sft['ms']:.2f} ms against a "
          f"bound of {sft['bound_ms']:.2f} ms ({sft['bound_by']}) [{card}]",
          flush=True)
    return {"fused_launches": launches}


def run_all_paths(torch, phys, F, dev, card):
    """Phase: the one-chunk runs through Simulation at 10**7 photons:
    thermal Comptonization (1024 iterations: no photon dies, |v| = c,
    energies finite and positive), the exponential transform (1024
    iterations: the weighted +x count is N (1 - p)**k within 5 sigma of
    the transform's own variance at every iteration) and Fe K-alpha
    fluorescence (40 iterations: the source and line populations within 5
    sigma of the two-rate closed form, deposits plus the energy in flight
    equal N E0 within 1e-4); returns each run's launches."""
    out = {}
    for case, iters in (("thermal", 1024), ("stretch", 1024),
                        ("fluor", FLUOR_K)):
        phase(f"{case} path: {RUN_ALL_N} photons, {iters} iterations")
        F.fused_transport.launches = 0
        sim, steps = run_all_sim(phys, case, RUN_ALL_N, torch.device(dev),
                                 iters)
        wall, _, peak = run_sim(torch, sim)
        launches = F.fused_transport.launches
        check(sim.used_fused and launches >= 1 and len(sim.ts) == iters,
              f"{case}: launches {launches}, {len(sim.ts)} iterations")
        st = sim.sim_state
        alive = st.alive[:RUN_ALL_N]
        k = np.arange(1, iters + 1)
        if case == "thermal":
            data = np.asarray(steps["sign"].data)
            speed = torch.linalg.vector_norm(st.v[:, :RUN_ALL_N].double(),
                                             dim=0)
            E = st.E[:RUN_ALL_N].double()
            v_err = float((speed / C_LIGHT - 1).abs().max())
            check(bool((data[:, 1] == RUN_ALL_N).all()) and v_err < 1e-5
                  and bool(torch.isfinite(E).all() and (E > 0).all()),
                  f"thermal: |v| off c by {v_err:.2e} or bad energies")
            what = (f"|v| = c within {v_err:.2e}, mean E'/E "
                    f"{float(E.mean()):.6f} (1 + 4 theta_e p k = "
                    f"{1 + 0.04 * 1e-3 * iters:.6f})")
        elif case == "stretch":
            W = np.asarray(steps["sign"].data)[:, 2]
            p, pb = 1e-3, 1e-3 * 0.3
            mean = RUN_ALL_N * (1 - p) ** k
            var = RUN_ALL_N * ((1 - p) ** (2 * k) / (1 - pb) ** k
                               - (1 - p) ** (2 * k))
            z = np.abs(W - mean) / np.sqrt(var)
            check(float(z.max()) < 5, f"stretch: weighted transmission off "
                  f"Beer-Lambert by {float(z.max()):.2f} sigma")
            what = (f"weighted transmission within {float(z.max()):.2f} "
                    f"sigma of N (1 - p)**k at every iteration (last "
                    f"{W[-1]:.6e} against {mean[-1]:.6e}); "
                    f"{int(alive.sum())} analog survivors")
        else:
            E = st.E[:RUN_ALL_N]
            pA, pB = FLUOR_P, FLUOR_P * (FLUOR_E0 / FLUOR_KA) ** 3
            nA = RUN_ALL_N * (1 - pA) ** iters
            nB = (RUN_ALL_N * pA * FLUOR_Y * ((1 - pA) ** iters
                                             - (1 - pB) ** iters)
                  / (pB - pA))
            gotA = int((alive & (E == np.float32(FLUOR_E0))).sum())
            gotB = int((alive & (E == np.float32(FLUOR_KA))).sum())
            dep = float(np.asarray(steps["dep"].data, np.float64)[:, 1].sum())
            budget = (dep + float(E[alive].double().sum())) / (
                RUN_ALL_N * FLUOR_E0) - 1
            zA, zB = (gotA - nA) / np.sqrt(nA), (gotB - nB) / np.sqrt(nB)
            check(abs(zA) < 5 and abs(zB) < 5 and abs(budget) < 1e-4,
                  f"fluorescence: N_A {gotA} ({zA:+.2f} sigma), N_B {gotB} "
                  f"({zB:+.2f} sigma), budget {budget:.2e}")
            what = (f"N_A = {gotA} against {nA:.1f} ({zA:+.2f} sigma), "
                    f"N_B = {gotB} against {nB:.1f} ({zB:+.2f} sigma); "
                    f"deposits + energy in flight = N E0 within "
                    f"{budget:+.2e}")
        print(f"{case} path: fused_transport launches {launches}; {what}; "
              f"{RUN_ALL_N * iters / wall:.4e} photon-steps/s from start() "
              f"({wall:.3f} s wall); peak memory {peak / 2 ** 30:.2f} GiB "
              f"[{card}]", flush=True)
        out[case] = {"fused_launches": launches}
        del sim, st, alive
    return out


def tissue_card_vs_cpu(torch, phys, F):
    """Phase: the tissue plan (kin -> fresnel -> hg -> implicit-capture
    absorption -> absorbing box -> a weighted plane tally with energy sums)
    at 2**16 photons on the card and on the CPU twin."""
    phase("tissue Simulation on the card against the CPU twin (2**16 "
          "photons)")
    light = phys.light
    c_dt = float(light.c) * 0.001
    L = 32 * c_dt
    n = 1 << 16
    runs = {}
    for where in ("cuda", "cpu"):
        sim = phys.Simulation(until_t=0.0635, seed=9, chunk_steps=32,
                              device=where)
        sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
        sim.add_step(1, phys.newton.NewtonianKinematicsStep())
        sim.add_step(2, light.RefractiveInterfaceStep(0.5 * L + 0.37 * c_dt,
                                                      1.0, 1.4, axis=2))
        sim.add_step(3, light.ScatterHenyeyGreensteinStep(
            A=0.1 / c_dt, n=1.0, g=0.9))
        dele = light.ScatterDeleteStep(1.0, 0.01 / c_dt,
                                       implicit_capture=True,
                                       measure_deposition=True)
        sim.add_step(4, dele)
        sim.add_step(5, phys.newton.AbsorbingBoundaryStep(((0.0, L),) * 3))
        far = light.ScatterMeasureStep(
            None, True, [(np.nan, np.nan, 0.2 * L)], weighted=True,
            measure_E=True, measure_E_mode="sum")
        sim.add_step(6, far)
        rng = np.random.default_rng(4)
        d = rng.normal(size=(3, n))
        sim.add_photons(light.generate_photon_state(
            n, E=1.0, v=d / np.linalg.norm(d, axis=0) * float(light.c),
            r=rng.uniform(0.1, 0.9, (3, n)) * L, device=where))
        sim.start()
        sim.join()
        st = sim.sim_state
        runs[where] = (sim, np.asarray(dele.data), np.asarray(far.data),
                       F.pack_state(st).cpu(), st.alive.cpu())
    (gs, gd, gf, gst, ga), (cs, cd, cf, cst, ca) = runs["cuda"], runs["cpu"]
    check(len(gs.ts) == 64 and gs.ts == cs.ts, "tissue run: sim.ts differs")
    check(np.array_equal(gf[:, :2], cf[:, :2]), "tissue run: alive counts "
          "differ")
    for g, c, what in ((gd, cd, "deposition"), (gf, cf, "far-plane")):
        check(np.allclose(g, c, rtol=RTOL_F, atol=RTOL * np.abs(c).max()),
              f"tissue run: {what} tallies out of tolerance")
    check(torch.equal(ga, ca), "tissue run: alive planes differ")
    bitwise = torch.equal(gst[:, ga], cst[:, ca])
    check(bitwise, "tissue run: live slots not bitwise equal")
    check("const-norm |dr| = c*dt: off" in gs.plan_report.notes,
          "tissue run: an interface before scattering must turn the "
          "const-norm path off")
    print(f"tissue card == CPU: sim.ts, alive counts ({int(ga.sum())} of "
          f"{n}), live slots bitwise; float tallies bitwise="
          f"{np.array_equal(gd, cd) and np.array_equal(gf, cf)}", flush=True)


def lorentz_plan_phase(torch, F, dev, seed, compare, card, times):
    """Phase: fused_transport against the twin on the six ``lorentz_plans``
    at 2**20 slots x 256 iterations over the growing-dt schedule, each
    timed with its counted bound."""
    C, K = 1 << 20, 256
    phase(f"fused_transport vs twin on the Lorentz and mixed plans (2**20 "
          f"slots, {K} iterations)")
    for i, (name, (plan, photons)) in enumerate(lorentz_plans(F, K).items()):
        check(plan.kernel_variant & 8, f"{name}: not the mixed variant")
        pk, sched, starts = lorentz_inputs(torch, plan, photons, C, K,
                                           dev, 40 + i)
        plain_ms = compare(name, pk, sched, K, plan, starts, "lorentz",
                           need_bitwise=True)
        out = torch.empty_like(pk)
        rec, _ = F.fused_transport(pk, out, sched, seed, K, plan,
                                   emit_starts=starts)
        if name == "mixed":  # pure B: the charges keep their speeds
            ch = (pk[15] == 0) & (pk[13] > 0)
            s0 = torch.linalg.vector_norm(pk[6:9, ch].double(), dim=0)
            s1 = torch.linalg.vector_norm(out[6:9, ch].double(), dim=0)
            check(float((s1 / s0 - 1).abs().max()) < 3e-5,
                  "mixed: charge speeds drifted in pure B")
        ms = cuda_ms(lambda: F.fused_transport(pk, out, sched, seed, K, plan,
                                               emit_starts=starts), 5, torch)
        events = expected_events(plan, pk, float(rec[:K, 0].double().sum()),
                                 0.001)
        b_ms, b_by = transport_bound(plan, C, K, starts, events)
        times[name] = ms
        print(f"{name} at 2**20 x {K}: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) [{card}]",
              flush=True)
        del pk, out


LOR_DT = 1e-3
LOR_CHUNK = 256          # run_all.py:27, steady_rate's chunk
EXB_N = 10_000_000       # run_all.py:530-543 lorentz_boris_exb_1e7
EXB_E, EXB_B, EXB_V0 = 4.0, 200.0, 1.0
MIX_N = 10_000_000       # run_all.py:549-566 mixed_species_1e7
MIX_ITERS = 4 * LOR_CHUNK
TILE_N = 10_000_000      # the record-tile plan
TILE_ITERS = 2 * 984


def exb_iterations():
    """Iterations of the ExB run: within its 3rd and 4th chunk, the count
    whose discrete gyro-phase n * 2 atan(h B) lies nearest a whole number of
    turns, so that the mean velocity over them is the drift."""
    theta = 2.0 * np.arctan(0.5 * EXB_B * LOR_DT)
    n = np.arange(3 * LOR_CHUNK + 1, 4 * LOR_CHUNK + 1)
    return int(n[np.argmin(np.abs(np.sin(n * theta / 2)))])


def boris64(n):
    """Velocity and position of one ExB particle after n Boris pushes and
    kinematic steps in float64 on the host."""
    E, B = np.array([EXB_E, 0.0, 0.0]), np.array([0.0, 0.0, EXB_B])
    h = 0.5 * LOR_DT
    t = h * B
    s = 2.0 / (1.0 + t @ t)
    v, r = np.array([EXB_V0, 0.0, 0.0]), np.zeros(3)
    for _ in range(n):
        v = v + h * E
        vp = v + np.cross(v, t)
        v = v + s * np.cross(vp, t) + h * E
        r = r + v * LOR_DT
    return v, r


def lorentz_sim(phys, case, n, dev, iters, seed=0):
    """run_all.py's lorentz_boris_exb_1e7 ("exb": n particles from the
    origin at v = (1, 0, 0) in E = (4, 0, 0), B = (0, 0, 200), q/m = 1, a
    sign tally) and mixed_species_1e7 ("mixed": n / 2 photons with isotropic
    scattering and absorption and n / 2 charges at v = (1, 0, 0) pushed by
    B alone); chunks of 256, ``iters`` iterations. Returns ``(sim, sign
    tally)``."""
    light, newton = phys.light, phys.newton
    sim = phys.Simulation(until_t=(iters - 0.5) * LOR_DT, seed=seed,
                          chunk_steps=LOR_CHUNK, device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(LOR_DT)))
    if case == "exb":
        sim.add_step(1, newton.LorentzForceStep(
            E_field=(EXB_E, 0.0, 0.0), B_field=(0.0, 0.0, EXB_B),
            q_over_m=1.0))
        sim.add_step(2, newton.NewtonianKinematicsStep())
        sign = light.ScatterSignMeasureStep(None, True)
        sim.add_step(3, sign)
        sim.add_particles(newton.generate_particle_state(
            n, v=(EXB_V0, 0.0, 0.0), device=dev))
        return sim, sign
    sim.add_step(1, newton.LorentzForceStep(B_field=(0.0, 0.0, EXB_B),
                                            q_over_m=1.0))
    sim.add_step(2, newton.NewtonianKinematicsStep())
    sim.add_step(3, light.ScatterIsotropicStep(A=np.double(0.001),
                                               n=np.double(0.001)))
    sim.add_step(4, light.ScatterDeleteStep(np.double(1e-9),
                                            np.double(1e-9)))
    sign = light.ScatterSignMeasureStep(None, True)
    sim.add_step(5, sign)
    sim.add_photons(light.generate_photon_state(n // 2, E=1.0, device=dev))
    sim.add_particles(newton.generate_particle_state(
        n // 2, v=(EXB_V0, 0.0, 0.0), device=dev))
    return sim, sign


def tile_sim(phys, n, dev, iters, seed=3):
    """The record-tile plan: n photons in isotropic directions from a cube
    of 3000 c dt (so that they cross the planes near its centre in every
    chunk), isotropic scattering (A n c dt = 1e-3), a weighted sign
    tally and a weighted two-plane tally with energy sums: 3 int and 7
    float record columns, whose tiles hold the chunk to 984 iterations.
    Returns ``(sim, sign, planes)``."""
    import torch

    light = phys.light
    c_dt = float(light.c) * LOR_DT
    sim = phys.Simulation(until_t=(iters - 0.5) * LOR_DT, seed=seed,
                          device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(LOR_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterIsotropicStep(A=0.001 / c_dt, n=1.0))
    sign = light.ScatterSignMeasureStep(None, True, weighted=True)
    sim.add_step(3, sign)
    planes = light.ScatterMeasureStep(
        None, True, [(0.37 * c_dt, np.nan, np.nan),
                     (np.nan, -0.61 * c_dt, np.nan)], weighted=True,
        measure_E=True, measure_E_mode="sum")
    sim.add_step(4, planes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = (torch.rand((3, n), generator=gen, device=dev) - 0.5) * 3000 * c_dt
    sim.add_photons(light.generate_photon_state(
        n, E=1.0, r=r, v=isotropic_v(torch, n, float(light.c), gen, dev),
        device=dev))
    return sim, sign, planes


def lorentz_runs(torch, phys, F, dev, card, xft, mft, tft):
    """Phase: the ExB, mixed and record-tile paths through Simulation at
    10**7 particles (ExB and mixed run twice, the second profiled for the
    idle share); returns each first run's launches."""
    dev = torch.device(dev)
    out = {}
    n_exb = exb_iterations()
    cases = (("exb", EXB_N, n_exb, xft), ("mixed", MIX_N, MIX_ITERS, mft))
    for case, n, iters, ft in cases:
        phase(f"{case} path: {n} particles, {iters} iterations in chunks of "
              f"{LOR_CHUNK}")

        def run(profile):
            F.fused_transport.launches = 0
            sim, sign = lorentz_sim(phys, case, n, dev, iters)
            wall, prof, peak = run_sim(torch, sim, profile)
            return sim, sign, wall, prof, peak, F.fused_transport.launches

        sim, sign, wall, _, peak, launches = run(False)
        print(sim.explain_plan())
        chunks = [k for _, k, _ in sim.chunk_log]
        check(sim.used_fused and launches >= 4 and len(sim.ts) == iters
              and chunks[:3] == [LOR_CHUNK] * 3,
              f"{case}: launches {launches}, chunks {chunks}")
        st = sim.sim_state
        alive = st.alive[:n]
        v, r = st.v[:, :n], st.r[:, :n]
        data = np.asarray(sign.data)
        if case == "exb":
            check(bool(alive.all()) and bool((data[:, 1] == n).all()),
                  "exb: particles lost")
            same = bool((v == v[:, :1]).all() and (r == r[:, :1]).all())
            check(same, "exb: the lanes differ from each other")
            v64, r64 = boris64(iters)
            v32 = v[:, 0].double().cpu().numpy()
            v_err = float(np.linalg.norm(v32 - v64) / np.linalg.norm(v64))
            mean = r[:, 0].double().cpu().numpy() / (iters * LOR_DT)
            drift = np.array([0.0, -EXB_E / EXB_B, 0.0])
            d_err = float(np.abs(mean - drift).max() / (EXB_E / EXB_B))
            check(v_err < 1e-4 and d_err < 0.01,
                  f"exb: v off float64 Boris by {v_err:.2e}, mean velocity "
                  f"off the ExB drift by {d_err:.2e}")
            what = (f"all {n} lanes bitwise equal; v = {v32.tolist()} "
                    f"against float64 Boris within {v_err:.2e}; mean "
                    f"velocity over {iters} steps (whole gyro-turns) "
                    f"{mean.tolist()} against ExB drift (0, -0.02, 0) within "
                    f"{d_err:.2e} of |drift|")
        else:
            ph = st.otype[:n] == 1
            k = np.arange(1, iters + 1)
            # the kill test pcoll >= u on a 24-bit uniform u: a photon dies
            # with (floor(pcoll 2**24) + 1) 2**-24, so at least 2**-24 (u =
            # 0) where pcoll = A n c dt is 3e-13
            p = (np.floor(1e-18 * C_LIGHT * LOR_DT * 2 ** 24) + 1) * 2.0 ** -24
            expect = (n // 2) * (1 - p) ** k + n // 2
            sigma = np.sqrt((n // 2) * (1 - (1 - p) ** k) * (1 - p) ** k)
            z = float(np.max(np.abs(data[:, 1] - expect)
                             / np.maximum(sigma, 1.0)))
            charged = int((alive & ~ph).sum())
            sp_ch = torch.linalg.vector_norm(v[:, alive & ~ph].double(),
                                             dim=0)
            sp_ph = torch.linalg.vector_norm(v[:, alive & ph].double(),
                                             dim=0)
            e_ch = float((sp_ch / EXB_V0 - 1).abs().max())
            e_ph = float((sp_ph / C_LIGHT - 1).abs().max())
            check(z <= 5 and charged == n // 2 and e_ch < 3e-5
                  and e_ph < 1e-6,
                  f"mixed: survivors {z:.2f} sigma off (1 - p)**k, "
                  f"{charged} charges alive, speeds off by {e_ch:.2e} "
                  f"(charges) and {e_ph:.2e} (photons)")
            what = (f"survivors within {z:.2f} sigma of (1 - p)**k; all "
                    f"{charged} charges alive, |v| = 1 within {e_ch:.2e}; "
                    f"photons |v| = c within {e_ph:.2e}")
        rate, steady_s = steady_rate(sim, np.full(len(sim.ts), n))
        print(f"{case} path: {len(sim.ts)} iterations in chunks {chunks}, "
              f"fused_transport launches {launches}; {what}")
        print(f"{case} path rate: {rate:.4e} particle-steps/s over the "
              f"dispatch loop after the first chunk, device clock "
              f"({steady_s * 1e3:.1f} ms); {n * len(sim.ts) / wall:.4e} from "
              f"start() ({wall:.3f} s wall); set-up {sim.setup_seconds:.3f} "
              f"s; peak memory {peak / 2 ** 30:.2f} GiB; kernel "
              f"{ft['ms']:.2f} ms per chunk against a bound of "
              f"{ft['bound_ms']:.2f} ms ({ft['bound_by']}) [{card}]",
              flush=True)
        out[case] = {"fused_launches": launches}
        del sim, st, alive, v, r
        sim2, _, _, prof, _, _ = run(True)
        busy, span = device_busy(prof, torch)
        print(f"{case} path device idle share (profiled second run, first to "
              f"last fused_transport kernel): {1 - busy / span:.4f} "
              f"({busy:.1f} ms busy of {span:.1f} ms) [{card}]", flush=True)
        del sim2, prof

    phase(f"record-tile path: {TILE_N} photons, {TILE_ITERS} iterations")
    F.fused_transport.launches = 0
    sim, sign, planes = tile_sim(phys, TILE_N, dev, TILE_ITERS)
    wall, _, peak = run_sim(torch, sim)
    launches = F.fused_transport.launches
    text = sim.explain_plan()
    print(text)
    chunks = [k for _, k, _ in sim.chunk_log]
    rows = np.asarray(planes.data, np.float64)
    check(sim.used_fused and chunks[:2] == [984, 984] and launches >= 2
          and "chunk 984: float record tiles" in text
          and rows.shape == (TILE_ITERS, 6) and np.isfinite(rows).all()
          and rows[:, 2].sum() > 0 and rows[984:, 4].sum() > 0,
          f"record-tile path: chunks {chunks}, launches {launches}, "
          f"records {rows.shape}")
    print(f"record-tile path: chunks {chunks} (clamped from 1024), "
          f"fused_transport launches {launches}; plane weight sums "
          f"{rows[:, 2].sum():.6e} and {rows[:, 4].sum():.6e}; "
          f"{TILE_N * len(sim.ts) / wall:.4e} photon-steps/s from start() "
          f"({wall:.3f} s wall); peak memory {peak / 2 ** 30:.2f} GiB; "
          f"kernel {tft['ms']:.2f} ms per chunk against a bound of "
          f"{tft['bound_ms']:.2f} ms ({tft['bound_by']}) [{card}]",
          flush=True)
    out["tile"] = {"fused_launches": launches}
    return out


def record_chain(C, grid_blocks):
    """The longest chain of float32 additions in one rec_f entry of a
    launch over C slots: the 5-level warp tree, the tiles a warp's slot
    accumulates, the 8 warps and the blocks of the second pass."""
    tiles = -(-C // 256)
    return 5 + -(-tiles // grid_blocks) + 8 + grid_blocks


def beer_lambert(torch, phys, grid, dev, card, grid_blocks):
    """Phase: exact Beer-Lambert at full size (no scatter, no roulette,
    BL_ITERS iterations inside the coverage)."""
    phase(f"exact Beer-Lambert: {MEDIA_N} photons, {MEDIA_NV}**3 trilinear "
          f"grid, {BL_ITERS} iterations of implicit capture")
    light = phys.light
    sim, dele, _, _, nfn = media_sim(phys, grid, dev, iters=BL_ITERS,
                                     scatter=False, roulette=None)
    sim.start()
    sim.join()
    check(sim.used_fused and len(sim.ts) == BL_ITERS,
          f"Beer-Lambert run: {len(sim.ts)} iterations")
    st = sim.sim_state
    check(int(st.n_alive) == MEDIA_N, "implicit capture killed photons")
    K = BL_ITERS
    # host replay of the kernel's float32 kinematics: x += f32(c * dt)
    c_dt = float(light.c) * MEDIA_DT
    dr = np.float32(np.float32(float(light.c)) * np.float32(MEDIA_DT))
    xs = np.empty(K, np.float32)
    x = np.float32(-0.75 * (4 * c_dt))  # media_sim's start
    for k in range(K):
        x = np.float32(x + dr)
        xs[k] = x
    idx = np.sort(np.random.default_rng(17).choice(MEDIA_N, BL_CHECKED,
                                                   replace=False))
    ti = torch.from_numpy(idx).to(dev)
    y = st.r[1, ti].cpu()
    z = st.r[2, ti].cpu()
    X = torch.from_numpy(xs)[:, None].expand(K, BL_CHECKED).contiguous()
    n_k = nfn(X, y[None].expand(K, -1).contiguous(),
              z[None].expand(K, -1).contiguous()).double().numpy()
    pcoll = (MEDIA_AA / c_dt) * c_dt * n_k
    w_expect = np.prod(1.0 - np.clip(pcoll, 0.0, 1.0), axis=0)
    w_got = st.w[ti].double().cpu().numpy()
    rel = float(np.max(np.abs(w_got / w_expect - 1)))
    # per iteration the kernel rounds 1 - p and the product once each
    tol_w = 2 * K * 2.0 ** -24
    check(rel <= tol_w, f"Beer-Lambert weights off the float64 product by "
          f"{rel:.3e} > {tol_w:.3e}")
    dep = float(np.asarray(dele.data, np.float64)[:, 1].sum())
    inflight = float((st.w.double() * st.E.double())[st.alive].sum())
    bal = abs((dep + inflight) / MEDIA_N - 1.0)
    # per photon and iteration dep + w rounds twice; each record is a
    # float32 sum along a chain of record_chain additions
    chain = record_chain(st.capacity, grid_blocks)
    tol_e = (2 * K + chain) * 2.0 ** -24
    check(bal <= tol_e, f"energy balance off by {bal:.3e} > {tol_e:.3e}")
    print(f"Beer-Lambert: {BL_CHECKED} photons' weights within {rel:.3e} of "
          f"the host float64 product (tolerance 2 K 2**-24 = {tol_w:.3e}); "
          f"mean weight {float(w_got.mean()):.4f} (range "
          f"{float(w_got.min()):.4f}-{float(w_got.max()):.4f}); energy "
          f"balance sum(dep) + sum(w E) = N E within {bal:.3e} (tolerance "
          f"(2 K + {chain}) 2**-24 = {tol_e:.3e}) [{card}]", flush=True)
    del sim, st


def media_path(torch, phys, F, grid, dev, card, mft):
    """Phase: the media path through ``Simulation`` at full size, run twice
    (the second profiled); returns its launch count."""
    phase(f"media path: {MEDIA_N} photons through a {MEDIA_NV}**3 trilinear "
          f"phantom, {MEDIA_ITERS} iterations")

    def run(profile):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        F.fused_transport.launches = 0
        t0 = time.perf_counter()
        sim, dele, meas, _, _ = media_sim(phys, grid, dev)
        torch.cuda.synchronize()
        t_pop = time.perf_counter() - t0
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            prof = prof_ctx(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
            prof.__enter__()
        t1 = time.perf_counter()
        sim.start()
        sim.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if prof is not None:
            prof.__exit__(None, None, None)
        return {"sim": sim, "dep": np.asarray(dele.data),
                "far": np.asarray(meas.data), "wall": wall, "t_pop": t_pop,
                "prof": prof, "fused": F.fused_transport.launches,
                "peak": torch.cuda.max_memory_allocated()}

    r1 = run(False)
    sim, dep, far = r1["sim"], r1["dep"], r1["far"]
    print(sim.explain_plan())
    check(sim.used_fused, "media path did not take the fused tier")
    check(r1["fused"] >= 2, f"{r1['fused']} kernel launches on the media "
          "path")
    chunks = [n for _, n, _ in sim.chunk_log]
    check(len(sim.ts) == MEDIA_ITERS and dep.shape == (MEDIA_ITERS, 2)
          and far.shape == (MEDIA_ITERS, 4),
          f"{len(sim.ts)} iterations, records {dep.shape} {far.shape}")
    check(bool(np.isfinite(dep).all() and np.isfinite(far).all()),
          "non-finite tallies")
    alive = far[:, 1]
    check(alive[0] == MEDIA_N and alive[-1] < alive[0] and alive[-1] > 0,
          f"alive counts {alive[0]} .. {alive[-1]}")
    check(dep[:, 1].min() >= 0 and dep[:, 1].sum() > 0, "no deposition")
    transmitted, t_energy = far[:, 2].sum(), far[:, 3].sum()
    check(0 < transmitted < MEDIA_N and abs(t_energy - transmitted)
          <= 1e-4 * transmitted, f"far-face tally {transmitted} "
          f"(energy {t_energy}; every photon has E = 1)")
    st = sim.sim_state
    w = st.w[st.alive].double()
    w_min, w_sur = MEDIA_ROULETTE
    check(bool((w > 0).all() and (w <= 1).all()), "weights outside (0, 1]")
    check(float(w.min()) >= w_min * (1 - 3 * MEDIA_AA), "roulette left a "
          f"weight {float(w.min())} below w_min")
    print(f"media path: {len(sim.ts)} iterations in chunks {chunks}, "
          f"fused_transport launches {r1['fused']}; alive {int(alive[0])} -> "
          f"{int(alive[-1])}; deposited {dep[:, 1].sum():.6e}, far-face "
          f"weight {transmitted:.6e} (energy {t_energy:.6e}); alive weights "
          f"{float(w.min()):.4f}-{float(w.max()):.4f}")
    photon_steps = float(alive.sum())
    first_done, last_done = sim.chunk_log[0][2], sim.chunk_log[-1][2]
    steady_n = float(alive[chunks[0]:].sum())
    steady_s = first_done.elapsed_time(last_done) * 1e-3
    print(f"media path rate: {steady_n / steady_s:.4e} alive photon-steps/s "
          f"over the dispatch loop after the first chunk, device clock "
          f"({steady_s * 1e3:.1f} ms); {photon_steps / r1['wall']:.4e} from "
          f"start() ({r1['wall']:.3f} s wall); set-up {sim.setup_seconds:.3f}"
          f" s in start() (grid upload included) + {r1['t_pop'] * 1e3:.1f} "
          f"ms for the bulk; peak memory {r1['peak'] / 2 ** 30:.2f} GiB; "
          f"kernel {mft['ms']:.2f} ms per chunk against a bound of "
          f"{mft['bound_ms']:.2f} ms ({mft['bound_by']}) [{card}]",
          flush=True)
    out = {"fused_launches": r1["fused"]}
    del sim, st, w, r1

    r2 = run(True)
    check(np.array_equal(dep, r2["dep"]) and np.array_equal(far, r2["far"]),
          "a second run with the same seed gave other tallies")
    busy, span = device_busy(r2["prof"], torch)
    print(f"media path device idle share (profiled second run, first to last "
          f"fused_transport kernel): {1 - busy / span:.4f} ({busy:.1f} ms "
          f"busy of {span:.1f} ms) [{card}]")
    print(r2["prof"].key_averages().table(sort_by="cuda_time_total",
                                          row_limit=8))
    return out


def media_card_vs_cpu(torch, phys, F, err):
    """Phase: a small media run (2**16 photons, a 32**3 trilinear grid for
    scattering, a layered z field for absorption) on the card and on the
    CPU twin."""
    phase("media Simulation on the card against the CPU twin (2**16 "
          "photons, 32**3 trilinear grid, layered absorption)")
    light = phys.light
    grid = media_grid(32, 5)
    sp = 4 * float(light.c) * MEDIA_DT
    runs = {}
    for where in ("cuda", "cpu"):
        lay = light.layered_density(np.array([0.0, 8.3, 19.6, 31.0]) * sp,
                                    [1.0, 2.0, 0.5], axis="z")
        sim, dele, far, sign, _ = media_sim(
            phys, grid, where, n=1 << 16, iters=192, chunk=64, seed=6,
            roulette=(0.4, 0.6), del_fn=lay, sign=True)
        sim.start()
        sim.join()
        st = sim.sim_state
        runs[where] = (sim, np.asarray(dele.data), np.asarray(far.data),
                       np.asarray(sign.data), F.pack_state(st).cpu(),
                       st.alive.cpu())
    (gs, gd, gf, gsg, gst, ga), (cs, cd, cf, csg, cst, ca) = (runs["cuda"],
                                                            runs["cpu"])
    check(len(gs.ts) == 192 and gs.ts == cs.ts, "media run: sim.ts differs")
    check(np.array_equal(gf[:, :2], cf[:, :2])
          and np.array_equal(gsg[:, :2], csg[:, :2]),
          "media run: int records differ")
    for g, c, what in ((gd, cd, "deposition"), (gf, cf, "far-face"),
                       (gsg, csg, "weighted sign")):
        check(np.allclose(g, c, rtol=RTOL_F, atol=RTOL * np.abs(c).max()),
              f"media run: {what} tallies out of tolerance")
    check(torch.equal(ga, ca), "media run: alive planes differ")
    ok, e = close_planes(gst[:, ga], cst[:, ca])
    err["media"] = max(err["media"], e)
    check(ok, f"media run: live slots differ (max abs err {e})")
    print(f"media card == CPU: sim.ts, int records, alive ({int(ga.sum())} "
          f"of {1 << 16}); live slots bitwise="
          f"{torch.equal(gst[:, ga], cst[:, ca])}, max abs err {e}; float "
          f"tallies bitwise={np.array_equal(gd, cd) and np.array_equal(gf, cf)}"
          , flush=True)


def planck_path(torch, phys, F, P, sampler, dev, card):
    """The slice's path at full size (phase 8); returns the launch counts
    of its first run."""
    phase(f"Planck source path: {PLANCK_N0} initial photons, {PLANCK_CAP} "
          f"slots, {PLANCK_ITERS} iterations")
    light = phys.light

    def run(profile):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        F.fused_transport.launches = P.planck_gen.launches = 0
        t0 = time.perf_counter()
        E0 = sampler.sample_device(7, PLANCK_N0, device=dev)
        bulk = light.generate_photon_state(PLANCK_N0, E=E0, device=dev)
        torch.cuda.synchronize()
        t_pop = time.perf_counter() - t0
        sim, meas = planck_sim(phys, sampler, bulk, dev)
        del E0, bulk
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof_ctx
            prof = prof_ctx(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
            prof.__enter__()
        t1 = time.perf_counter()
        sim.start()
        sim.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if prof is not None:
            prof.__exit__(None, None, None)
        return {"sim": sim, "meas": meas, "wall": wall, "t_pop": t_pop,
                "prof": prof, "fused": F.fused_transport.launches,
                "planck": P.planck_gen.launches,
                "peak": torch.cuda.max_memory_allocated()}

    r1 = run(False)
    sim, data = r1["sim"], np.asarray(r1["meas"].data)
    print(sim.explain_plan())
    check(sim.used_fused, "Planck path did not take the fused tier")
    check(r1["fused"] >= 4 and r1["planck"] >= 1,
          f"kernel launches on the Planck path: fused_transport "
          f"{r1['fused']}, planck_gen {r1['planck']}")
    chunks = [n for _, n, _ in sim.chunk_log]
    check(len(sim.ts) == PLANCK_ITERS and data.shape == (PLANCK_ITERS, 6),
          f"{len(sim.ts)} iterations, records {data.shape}")
    check(sum(chunks) == PLANCK_ITERS and max(chunks) == 1024,
          f"chunks {chunks}")
    log = sim.population_log
    stops = [e for e in log if e[0] == "capacity-stop"]
    recycles = [e for e in log if e[0] == "recycle"]
    check(stops and stops[0][1] == 0,
          f"emission did not stop at capacity in chunk 0: {log}")
    check(recycles and recycles[0][1] == 1,
          f"recycling did not fire before chunk 1: {log}")
    print(f"arena: capacity stop at chunk {stops[0][1]} iteration "
          f"{stops[0][2]} (spawn mark {stops[0][3]} of {PLANCK_CAP}); "
          f"{len(recycles)} recycles, the first before chunk "
          f"{recycles[0][1]} (spawn mark {recycles[0][2]} -> "
          f"{recycles[0][3]}); chunks {chunks}")
    n_star = PLANCK_EMIT * (1 - PLANCK_P_DEL) / PLANCK_P_DEL
    tail = data[-[c for c in chunks if c][-1]:, 1]
    dev_star = float(np.max(np.abs(tail / n_star - 1)))
    check(dev_star < 0.03, f"last chunk's alive count off N* = {n_star:.0f} "
          f"by {dev_star:.4f}")
    check(bool(np.isfinite(data).all()), "non-finite tallies")
    counts, esums = data[:, 2::2], data[:, 3::2]
    check(bool((counts.sum(0) > 0).all() and (esums.sum(0) > 0).all()),
          "a plane was never crossed")
    st = sim.sim_state
    alive_E = st.E[st.alive].double().cpu().numpy()
    spec = density_check(alive_E, light, SPECTRUM_TOL)
    print(f"Planck path: N* = {n_star:.0f}, last chunk within "
          f"{dev_star:.4f}; alive spectrum within {spec:.4f} of the Planck "
          f"density ({len(alive_E)} photons); plane 0 crossings "
          f"{int(counts[:, 0].sum())}, energy {esums[:, 0].sum():.6e}")
    slot_steps = PLANCK_CAP * PLANCK_ITERS
    photon_steps = float(data[:, 1].sum())
    first_done, last_done = sim.chunk_log[0][2], sim.chunk_log[-1][2]
    steady_n = float(data[chunks[0]:, 1].sum())
    steady_s = first_done.elapsed_time(last_done) * 1e-3
    print(f"Planck path rate: {steady_n / steady_s:.4e} photon-steps/s "
          f"(alive photons) over the dispatch loop after the first chunk, "
          f"device clock ({steady_s * 1e3:.1f} ms); "
          f"{PLANCK_CAP * sum(chunks[1:]) / steady_s:.4e} slot-steps/s "
          f"[{card}]")
    print(f"Planck path from start(): {photon_steps / r1['wall']:.4e} "
          f"photon-steps/s, {slot_steps / r1['wall']:.4e} slot-steps/s "
          f"({r1['wall']:.3f} s wall); set-up {sim.setup_seconds:.3f} s "
          f"in start() + {r1['t_pop'] * 1e3:.3f} ms sample_device and "
          f"generate_photon_state; peak memory "
          f"{r1['peak'] / 2 ** 30:.2f} GiB [{card}]", flush=True)
    out = {"fused_launches": r1["fused"], "planck_launches": r1["planck"]}
    ts1 = list(sim.ts)
    del sim, st, r1

    r2 = run(True)
    data2 = np.asarray(r2["meas"].data)
    check(np.array_equal(data, data2), "a second run with the same seed "
          "gave other tallies")
    check(r2["sim"].ts == ts1,
          "a second run with the same seed gave another clock")
    busy, span = device_busy(r2["prof"], torch)
    print(f"Planck path device idle share (profiled second run, first to "
          f"last fused_transport kernel, recycling included): "
          f"{1 - busy / span:.4f} ({busy:.1f} ms busy of {span:.1f} ms) "
          f"[{card}]")
    print(r2["prof"].key_averages().table(sort_by="cuda_time_total",
                                          row_limit=12))
    print("Planck path: tallies and clock bitwise equal in a second run "
          "with the same seed", flush=True)
    return out


def card_vs_cpu(torch, phys, F, sampler, err):
    light = phys.light
    phase("Simulation on the card against the CPU twin (2**16 photons, "
          "t-exit on a chunk boundary)")
    runs = {}
    for where in ("cuda", "cpu"):
        sim = phys.Simulation(exit=lambda s: s.t >= 0.1275, seed=5,
                              chunk_steps=64, device=where)
        sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
        sim.add_step(1, phys.newton.NewtonianKinematicsStep())
        sim.add_step(2, light.ScatterDeleteStep(np.double(0.001),
                                                np.double(1e-4)))
        sim.add_step(3, light.ScatterIsotropicStep(A=np.double(0.001),
                                                   n=np.double(0.001)))
        meas = light.ScatterSignMeasureStep(None, True)
        sim.add_step(4, meas)
        sim.add_photons(light.generate_photon_state(1 << 16, E=1.0))
        sim.start()
        sim.join()
        runs[where] = (sim, np.asarray(meas.data),
                       F.pack_state(sim.sim_state).cpu())
    (gs, gdata, gstate), (cs, cdata, cstate) = runs["cuda"], runs["cpu"]
    check([n for _, n, _ in gs.chunk_log] == [64, 64, 0],
          f"chunks {[n for _, n, _ in gs.chunk_log]}, expected 64, 64, 0")
    check(gs.ts == cs.ts, "sim.ts differs between card and CPU")
    check(np.array_equal(gdata, cdata), "records differ between card and CPU")
    check(bool(torch.isfinite(gstate).all()), "non-finite state on the card")
    ok, e = close_planes(gstate, cstate)
    err["main"] = max(err["main"], e)
    check(ok, f"final state differs between card and CPU (max abs err {e})")
    print(f"card == CPU: sim.ts, {len(gdata)} record rows; final state "
          f"bitwise={torch.equal(gstate, cstate)}, max abs err {e}, alive "
          f"{int(gdata[-1, 1])} of {1 << 16}", flush=True)

    phase("emitter Simulation on the card against the CPU twin (Planck "
          "energies, plane tallies, recycling at chunk_steps=32)")
    runs = {}
    for where in ("cuda", "cpu"):
        sim = phys.Simulation(until_t=0.1995, seed=2, capacity=16384,
                              chunk_steps=32, device=where)
        sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
        sim.add_step(1, light.PhotonEmitterStep(500, E=sampler,
                                                isotropic=True))
        sim.add_step(2, phys.newton.NewtonianKinematicsStep())
        sim.add_step(3, light.ScatterDeleteStep(np.double(0.001),
                                                np.double(0.001)))
        c_dt = float(light.c) * 0.001
        cross = light.ScatterMeasureStep(
            None, True, [(2.5 * c_dt, np.nan, np.nan),
                         (np.nan, -1.5 * c_dt, np.nan)],
            measure_E=True, measure_E_mode="sum")
        sim.add_step(4, cross)
        sign = light.ScatterSignMeasureStep(None, True)
        sim.add_step(5, sign)
        sim.add_photons(light.generate_photon_state(100, E=1.0))
        sim.start()
        sim.join()
        st = sim.sim_state
        runs[where] = (sim, np.asarray(cross.data), np.asarray(sign.data),
                       F.pack_state(st).cpu(), int(st.n_spawned),
                       st.alive.cpu())
    (gs, gx, gsg, gst, gsp, ga), (cs, cx, csg, cst, csp, ca) = (
        runs["cuda"], runs["cpu"])
    check(len(gs.ts) == 200 and gs.ts == cs.ts,
          "emitter run: sim.ts differs between card and CPU")
    check(np.array_equal(gsg, csg), "emitter run: sign records differ")
    check(np.array_equal(gx[:, [0, 1, 2, 4]], cx[:, [0, 1, 2, 4]]),
          "emitter run: crossing counts differ")
    check(np.allclose(gx[:, [3, 5]], cx[:, [3, 5]], rtol=RTOL_F, atol=0),
          "emitter run: energy sums out of tolerance")
    check(gsp == csp, f"emitter run: spawn marks {gsp} != {csp}")
    check(gs.population_log == cs.population_log,
          "emitter run: recycling differs")
    check(sum(1 for e in gs.population_log if e[0] == "recycle") >= 3,
          f"emitter run: too little recycling {gs.population_log}")
    check(torch.equal(ga, ca), "emitter run: alive planes differ")
    ok, e = close_planes(gst[:, ga], cst[:, ca])
    err["planck"] = max(err["planck"], e)
    check(ok, f"emitter run: live slots differ (max abs err {e})")
    print(f"emitter card == CPU: sim.ts, sign and crossing records, spawn "
          f"mark {gsp}, {len(gs.population_log)} arena events; live slots "
          f"bitwise={torch.equal(gst[:, ga], cst[:, ca])}, max abs err {e}; "
          f"energy sums bitwise={np.array_equal(gx, cx)}", flush=True)


# -- polarized transport (kernel 1h) -----------------------------------------

POL_DT = 1e-3
POL_N = 10_000_000       # run_all.py:391-413 polarized_rayleigh_1e7
POL_ITERS = 2 * 1024
POLI_N = 10_000_000      # make_polarimetry_nb.py:154-166 at 10**7 photons
POLI_ITERS = 1024        # one chunk
POLI_ALPHA = 0.5


def pol_packed(C, extras, seed, photons=1.0):
    """Seeded (15 + len(extras), C) state of a polarized population: photons
    at c in random directions with E in [0.5, 2] and w in [0.5, 1], ~95%
    alive; Stokes vectors in random directions at a random degree (a tenth
    fully polarized); frames perpendicular to v, a tenth of them zero (the
    degenerate fallback). With ``photons`` < 1 the rest are charges at [0.1,
    0.5] c with E = 0, marked in the "otype" plane."""
    rng = np.random.default_rng(seed)
    p = np.zeros((15 + len(extras), C), np.float32)
    p[0:3] = rng.normal(size=(3, C)) * 30 * C_LIGHT * POL_DT
    d = rng.normal(size=(3, C))
    d /= np.linalg.norm(d, axis=0)
    photon = rng.uniform(size=C) < photons
    p[6:9] = d * np.where(photon, 1.0, rng.uniform(0.1, 0.5, C)) * C_LIGHT
    p[12] = np.where(photon, rng.uniform(0.5, 2.0, C), 0.0)
    p[13] = rng.uniform(size=C) < 0.95
    p[14] = rng.uniform(0.5, 1.0, C)
    s = rng.normal(size=(3, C))
    s *= np.where(rng.uniform(size=C) < 0.1, 1.0, rng.uniform(0.0, 1.0, C)) \
        / np.linalg.norm(s, axis=0)
    ref = rng.normal(size=(3, C))
    e1 = ref - (ref * d).sum(0) * d
    e1 /= np.linalg.norm(e1, axis=0)
    e1[:, rng.uniform(size=C) < 0.1] = 0.0
    for j, name in enumerate(extras):
        base, _, row = name.partition(":")
        p[15 + j] = (s[int(row)] if base == "stokes" else
                     e1[int(row)] if base == "pol_ref" else photon)
    return p


def pol_plans(F, light, chunk):
    """The polarized plans, each ``(plan, photon share of pol_packed)``:
    Rayleigh (packed angles), with lambda**-4 and with a C-expression n(r);
    Compton, with sigma_KN and the heating tally; the Stokes tally alone
    (weighted, local Q and U) and after a Rayleigh scatter; a directed
    polarized source and an isotropic circular one filling the upper half of
    the slots over stale Stokes and frame rows; fluorescence on a polarized
    population with no polarized op; a mixed photon/charged population
    (tests/test_torch_cuda.py holds the same plans at 2**16 x 64)."""
    from physicl_tpu_torch.state import OBJ_PHOTON

    c_dt = C_LIGHT * POL_DT
    both = ("stokes", "pol_ref")
    rows = F.POL_ROWS

    def plan(ops, extras=rows, wb=both, n_f=0, species=OBJ_PHOTON,
             sign=True):
        ops = [F._Op("kin"), *ops] + ([F._Op("sign", cols=(1, 2))]
                                      if sign else [])
        return F.FusedPlan(ops=ops, n_rec_cols=5 if sign else 2,
                           chunk=chunk, const_norm_speed=C_LIGHT,
                           n_frec_cols=n_f, species=species, extras=extras,
                           extras_writeback=wb)

    def pol(**kw):
        kw.setdefault("coef", 0.1 / c_dt)
        return F._Op("pol", c_val=C_LIGHT, **kw)

    def polc(**kw):
        return F._Op("polc", coef=0.1 / c_dt, c_val=C_LIGHT, inv_mec2=2.0,
                     kn_tries=12, **kw)

    def emit(**kw):
        return F._Op("emit", emit_n=2048, emit_E=1.0, c_val=C_LIGHT, **kw)

    expr = light._compile_variable_n(
        f"1.0 + 0.5 * sin(r0[gid] / {10 * c_dt}) * cos(r2[gid] / "
        f"{7 * c_dt})")
    return {
        "pol": (plan([pol()]), 1.0),
        "pol-wl": (plan([pol(coef=1.0, wl_base=(0.1 / c_dt) ** 0.25)]),
                   1.0),
        "pol-expr": (plan([pol(n_fn=expr)]), 1.0),
        "polc": (plan([polc()]), 1.0),
        "polc-kn-dep": (plan([polc(kn_xsec=True, cols=(0,))], n_f=1), 1.0),
        "polmeas-w-qu": (plan([F._Op("polmeas", cols=(1, 0), weighted=True,
                                     local_qu=True)],
                              extras=rows[:3], wb=(), n_f=5, sign=False),
                         1.0),
        "pol-polmeas": (plan([pol(), F._Op("polmeas", cols=(-1, 0))],
                             n_f=3), 1.0),
        "emit-pol-directed": (plan([emit(
            emit_v=(0.6 * C_LIGHT, 0.8 * C_LIGHT, 0.0),
            emit_stokes=(0.6, 0.0, 0.8), emit_polref=(0.0, 0.0, 1.0)),
            pol()]), 1.0),
        "emit-iso-circular": (plan([emit(emit_stokes=(0.0, 0.0, 1.0),
                                         emit_polref=(0.0, 0.0, 0.0)),
                                    pol()]), 1.0),
        "fluor-pol-planes": (plan([F._Op(
            "del", coef=0.05 / c_dt, c_val=C_LIGHT,
            fluor=(0.5, 0.8, 0.6))]), 1.0),
        "mixed-pol": (plan([pol(), F._Op("del", coef=0.01 / c_dt)],
                           extras=rows + ("otype",),
                           species=F.SPECIES_MIXED), 0.5),
    }


def pol_inputs(torch, plan, photons, C, K, dev, seed):
    """(packed, sched, emit starts or None) for a ``pol_plans`` plan; an
    emitter's plan gets the upper half of the slots dead (their stale
    Stokes and frame rows kept), filled from C / 2 at its rate."""
    p = pol_packed(C, plan.extras, seed, photons)
    starts = None
    if plan.n_emit:
        p[13, C // 2:] = 0.0
        n = plan.ops[1].emit_n
        starts = torch.full((1, K), -(2 ** 30), dtype=torch.int32)
        fits = min(K, (C - C // 2) // n)
        starts[0, :fits] = C // 2 + n * torch.arange(fits,
                                                     dtype=torch.int32)
        starts = starts.to(dev)
    sched = torch.zeros((5, K), dtype=torch.float32)
    sched[0] = sched[3] = sched[4] = POL_DT
    return torch.from_numpy(p).to(dev), sched.to(dev), starts


def pol_plan_phase(torch, F, light, dev, seed, compare, card, times):
    """Phase (a): fused_transport against the twin on the eleven polarized
    plans at 2**20 slots x 256 iterations: int records equal, every plane
    (the Stokes and frame rows included) bitwise, rec_f within rtol 1e-5;
    each timed against its bound, with its grid and the instantiation's
    registers."""
    C, K = 1 << 20, 256
    phase(f"fused_transport vs twin on the polarized plans (2**20 slots, {K} "
          "iterations)")
    for i, (name, (plan, photons)) in enumerate(pol_plans(F, light,
                                                          K).items()):
        check(plan.kernel_variant & 24 == 24, f"{name}: not the "
              "polarization variant")
        pk, sched, starts = pol_inputs(torch, plan, photons, C, K, dev,
                                       60 + i)
        plain_ms = compare(name, pk, sched, K, plan, starts, "pol",
                           need_bitwise=True)
        out = torch.empty_like(pk)
        rec, _ = F.fused_transport(pk, out, sched, seed, K, plan,
                                   emit_starts=starts)
        torch.cuda.synchronize()
        if plan.extras_writeback and not plan.n_emit:
            check(not torch.equal(out[15:21], pk[15:21]),
                  f"{name}: no Stokes or frame row changed")
        ms = cuda_ms(lambda: F.fused_transport(pk, out, sched, seed, K, plan,
                                               emit_starts=starts), 5, torch)
        events = expected_events(plan, pk, float(rec[:K, 0].double().sum()),
                                 POL_DT)
        b_ms, b_by = transport_bound(plan, C, K, starts, events)
        grid = F.kernel_grid(plan, C, K)
        times[name] = ms
        print(f"{name} at 2**20 x {K}: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), grid "
              f"{grid} blocks ({grid / 132:.2f} per SM), variant "
              f"{plan.kernel_variant} ({kernel_regs(plan.kernel_variant)}) "
              f"[{card}]", flush=True)
        del pk, out


def kernel_regs(variant, plan=None):
    """The ptxas register line of fused_transport's instantiation
    ``variant`` (its template arguments in the mangled name), or '?'; a
    user plan's (``plan`` with user ops) from its own library's build."""
    from physicl_tpu_torch.ops import _build

    kernel, args = sass_loop().mangled_pattern(variant)
    log = (_build.build_log if plan is None or not plan.has_user
           else user_build(plan).get("log", ""))
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if kernel in line and args in line and "Compiling" in line:
            spill = ""
            for nxt in lines[i + 1:i + 4]:
                if "spill" in nxt:
                    spill = nxt.split(":")[-1].strip()
                if "registers" in nxt:
                    regs = nxt.split("Used")[-1].strip()
                    return f"{regs}; {spill}" if spill else regs
    return "?"


def sass_loop():
    """scripts/sass_loop.py, the SASS instruction counter."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import sass_loop as sl

    return sl


def main_loops():
    """{variant: scripts/sass_loop.py's summary} of the main plan's op-
    sequence instantiation (64) and of the generic variant 0, from the
    built library's SASS."""
    sl = sass_loop()
    funcs = sl.functions(sl.built_sass())
    return {v: sl.variant_summary(funcs, v) for v in (64, 0)}


def pol_scatter_once(torch, F, kind, stokes, n, dev, seed, inv_mec2=0.0):
    """n photons at E = 1 in isotropic directions at c, frames from the
    generic perpendicular, Stokes ``stokes``, through one iteration of
    [kin, ``kind``] on the kernel with pcoll = 2 (every photon scatters):
    (incoming directions, the state after)."""
    c_dt = C_LIGHT * POL_DT
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = isotropic_v(torch, n, 1.0, gen, dev)
    use_z = d[2].abs() < 0.9
    ref = torch.stack([torch.zeros_like(d[0]),
                       (~use_z).float(), use_z.float()])
    e1 = ref - (ref * d).sum(0) * d
    e1 = e1 / torch.linalg.vector_norm(e1, dim=0)
    p = torch.zeros((21, n), dtype=torch.float32, device=dev)
    p[6:9] = d * C_LIGHT
    p[12], p[13], p[14] = 1.0, 1.0, 1.0
    p[15:18] = torch.tensor(stokes, dtype=torch.float32,
                            device=dev)[:, None]
    p[18:21] = e1
    op = F._Op(kind, coef=2.0 / c_dt, c_val=C_LIGHT, inv_mec2=inv_mec2,
               kn_tries=12)
    plan = F.FusedPlan(ops=[F._Op("kin"), op], n_rec_cols=1, chunk=1,
                       const_norm_speed=C_LIGHT, extras=F.POL_ROWS,
                       extras_writeback=("stokes", "pol_ref"))
    sched = torch.full((5, 1), POL_DT, dtype=torch.float32, device=dev)
    out = torch.empty_like(p)
    F.fused_transport(p, out, sched, seed, 1, plan)
    return d.double(), out.double()


def pol_frame_errors(out, torch):
    """(max purity, max ||e1| - 1|, max |e1 . d|) of a packed state."""
    d = out[6:9] / torch.linalg.vector_norm(out[6:9], dim=0)
    e1 = out[18:21]
    return (float(torch.linalg.vector_norm(out[15:18], dim=0).max()),
            float((torch.linalg.vector_norm(e1, dim=0) - 1).abs().max()),
            float((e1 * d).sum(0).abs().max()))


def pol_law_phase(torch, F, dev, card):
    """Phase (b): the exact per-photon laws of one forced scatter (pcoll =
    2, as make_polarimetry_nb.py) on the kernel at 2**20 photons: pol on
    unpolarized light gives Q' = (c**2 - 1) / (1 + c**2), U' = V' = 0; on
    circular light V' = 2c / (1 + c**2); polc at alpha = 0.5 gives Q' =
    -s**2 / (kappa - s**2) and E' = E / eta, eta = 1 + alpha (1 - c); in
    every case p <= 1, |e1| = 1 and e1 . d = 0 within 1e-5."""
    phase("polarization laws (2**20 photons, one forced scatter)")
    n = 1 << 20
    worst = {}
    for case, kind, stokes, inv_mec2 in (
            ("rayleigh-unpolarized", "pol", (0.0, 0.0, 0.0), 0.0),
            ("rayleigh-circular", "pol", (0.0, 0.0, 1.0), 0.0),
            ("compton-unpolarized", "polc", (0.0, 0.0, 0.0), POLI_ALPHA)):
        d, out = pol_scatter_once(torch, F, kind, stokes, n, dev, 5,
                                  inv_mec2)
        # Kahn's tries leave ~1e-4 of the Compton photons unscattered
        hit = (out[9:12] != 0).any(0)
        share = float(hit.double().mean())
        check(share == 1.0 if kind == "pol" else share > 0.999,
              f"{case}: {share} of the photons scattered")
        d, out = d[:, hit], out[:, hit]
        c = (out[6:9] / torch.linalg.vector_norm(out[6:9], dim=0)
             * d).sum(0)
        q, u, v = out[15], out[16], out[17]
        if kind == "pol":
            want_q = (c * c - 1) / (1 + c * c)
            want_v = 2 * c / (1 + c * c) * stokes[2]
            errs = [float((q - want_q).abs().max()),
                    float(u.abs().max()), float((v - want_v).abs().max())]
        else:
            eta = 1 + POLI_ALPHA * (1 - c)
            kappa = eta + 1 / eta
            s2 = 1 - c * c
            errs = [float((q + s2 / (kappa - s2)).abs().max()),
                    float(u.abs().max()), float(v.abs().max()),
                    float((out[12] * eta - 1).abs().max())]
        p_max, n_err, dot = pol_frame_errors(out, torch)
        law = max(errs)
        check(law < 1e-5 and p_max <= 1 + 1e-5 and n_err < 1e-5
              and dot < 1e-5,
              f"{case}: law off by {errs}, purity {p_max}, |e1| - 1 "
              f"{n_err}, e1 . d {dot}")
        worst[case] = law
        print(f"{case}: {share:.6f} of the photons scattered; law within "
              f"{law:.2e} "
              f"({', '.join(f'{e:.2e}' for e in errs)}); max purity "
              f"{p_max:.8f}; ||e1| - 1| <= {n_err:.2e}; |e1 . d| <= "
              f"{dot:.2e} [{card}]", flush=True)
        del d, out, c


def pol_sim(phys, case, n, dev, iters=None, seed=0, chunk=1024):
    """run_all.py:391-413 polarized_rayleigh_1e7 ("polarized": n
    unpolarized photons along +x, Rayleigh with A = n = 1e-3, chunks of
    1024) and make_polarimetry_nb.py:154-166 ("polarimetry": n photons
    linearly polarized along z, forced polarized Compton at alpha = 0.5
    with the heating tally, the Stokes tally without local Q and U, one
    chunk). Returns ``(sim, Stokes tally or None, Compton step or
    None)``."""
    pol = phys.polarization
    iters = iters or (POL_ITERS if case == "polarized" else POLI_ITERS)
    sim = phys.Simulation(until_t=(iters - 0.5) * POL_DT, seed=seed,
                          chunk_steps=chunk, device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(POL_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    if case == "polarized":
        sim.add_step(2, pol.ScatterPolarizedRayleighStep(
            A=np.double(0.001), n=np.double(0.001)))
        sim.add_photons(pol.polarized_photon_state(n, E=1.0, device=dev))
        return sim, None, None
    a = np.sqrt(2.0 / (float(phys.light.c) * POL_DT))  # pcoll = 2
    comp = pol.ScatterPolarizedComptonStep(
        A=np.double(a), n=np.double(a), mec2=1.0 / POLI_ALPHA,
        measure_deposition=True)
    sim.add_step(2, comp)
    sm = pol.StokesMeasureStep(None, local_qu=False)
    sim.add_step(3, sm)
    sim.add_photons(pol.polarized_photon_state(
        n, E=1.0, stokes=(1.0, 0.0, 0.0), device=dev))
    return sim, sm, comp


def pol_paths(torch, phys, F, dev, card, pft, ift, grids):
    """Phases (c) and (d): the polarized Rayleigh path and the polarimetry
    path through Simulation at 10**7 photons (each run twice, the second
    profiled for the idle share); returns each first run's launches."""
    out = {}
    for case, ft in (("polarized", pft), ("polarimetry", ift)):
        n = POL_N if case == "polarized" else POLI_N
        iters = POL_ITERS if case == "polarized" else POLI_ITERS
        phase(f"{case} path: {n} photons, {iters} iterations")

        def run(profile):
            F.fused_transport.launches = 0
            sim, sm, comp = pol_sim(phys, case, n, torch.device(dev))
            wall, prof, peak = run_sim(torch, sim, profile)
            return sim, sm, comp, wall, prof, peak, F.fused_transport.launches

        sim, sm, comp, wall, _, peak, launches = run(False)
        text = sim.explain_plan()
        print(text)
        # the t-exit on a chunk boundary dispatches an empty last chunk
        chunks = [k for _, k, _ in sim.chunk_log]
        check(sim.used_fused and len(sim.ts) == iters
              and [k for k in chunks if k] == [1024] * (iters // 1024)
              and launches == len(chunks)
              and "kernel writes back: stokes, pol_ref" in text,
              f"{case}: launches {launches}, chunks {chunks}")
        st = sim.sim_state
        live = st.alive[:n]
        stokes, frame, v = (st.extras["stokes"][:, :n],
                            st.extras["pol_ref"][:, :n], st.v[:, :n])
        check(bool(live.all()), f"{case}: photons died")
        finite = bool(torch.isfinite(stokes).all()
                      and torch.isfinite(frame).all()
                      and torch.isfinite(v).all())
        speed = torch.linalg.vector_norm(v.double(), dim=0)
        d = v.double() / speed
        e1 = frame.double()
        purity = torch.linalg.vector_norm(stokes.double(), dim=0)
        p_max = float(purity.max())
        n_err = float((torch.linalg.vector_norm(e1, dim=0) - 1).abs().max())
        dot = float((e1 * d).sum(0).abs().max())
        v_err = float((speed / C_LIGHT - 1).abs().max())
        check(finite and p_max <= 1 + 1e-6 and n_err < 1e-5 and dot < 1e-5
              and v_err < 1e-6,
              f"{case}: finite {finite}, purity {p_max}, |e1| - 1 {n_err}, "
              f"e1 . d {dot}, |v| / c - 1 {v_err}")
        what = (f"max purity {p_max:.8f}, ||e1| - 1| <= {n_err:.2e}, |e1 . "
                f"d| <= {dot:.2e}, |v| = c within {v_err:.2e}, mean purity "
                f"{float(purity.mean()):.6f}")
        if case == "polarimetry":
            rows = np.asarray(sm.data, np.float64)
            # the source is pure (p = 1); the first three scatters
            # depolarize (the Fano matrix's kappa - 2), then the recoil
            # lowers alpha toward the Thomson limit and the mean purity
            # recovers: the JAX package's rows at 4096 photons have this
            # shape (tests/test_torch_polarization.py, case "polarimetry")
            p_mean = rows[:12, 2]
            check(rows.shape == (iters, 4) and p_mean[0] > p_mean[1] >
                  p_mean[2] and bool((np.diff(p_mean[2:]) > 0).all())
                  and bool((p_mean < 0.97).all()),
                  f"polarimetry: the mean purity over the first 12 rows does "
                  f"not fall from 1 for three rows and then rise: "
                  f"{p_mean.tolist()}")
            ref = (float(purity.mean()), float(stokes[2].double().mean()))
            last = rows[-1, 2:4]
            scale = max(abs(ref[0]), 1e-30)
            off = [abs(last[j] - ref[j]) / scale for j in range(2)]
            check(max(off) <= 1e-5, f"polarimetry: the last Stokes row "
                  f"{last.tolist()} against the final planes' means {ref}")
            dep = np.asarray(comp.data, np.float64)
            E = float(st.E[:n].double().sum())
            chain = record_chain(st.capacity, grids[case])
            tol = (chain + 2) * 2.0 ** -24 * float(np.abs(dep[:, 1]).sum()) \
                + n * 2.0 ** -24
            balance = float(dep[:, 1].sum()) + E - n
            check(dep.shape == (iters, 2) and abs(balance) <= tol,
                  f"polarimetry: deposits + sum E - N E0 = {balance:.4e} "
                  f"beyond {tol:.4e}")
            what += (f"; purity over the first 12 rows "
                     f"{np.round(p_mean, 6).tolist()}; last row (p, V) "
                     f"{last.tolist()} against the planes' {ref} within "
                     f"{max(off):.2e}; deposits + sum E - N E0 = "
                     f"{balance:.4e} (allowed {tol:.4e})")
        print(f"{case} path: {len(sim.ts)} iterations in chunks {chunks}, "
              f"fused_transport launches {launches}; {what}")
        if len([k for k in chunks if k]) > 1:
            rate, steady_s = steady_rate(sim, np.full(len(sim.ts), n))
            loop = (f"{rate:.4e} photon-steps/s over the dispatch loop "
                    f"after the first chunk, device clock "
                    f"({steady_s * 1e3:.1f} ms)")
        else:  # one chunk: the loop after it is empty
            loop = (f"one chunk: {n * chunks[0] / ft['ms'] * 1e3:.4e} "
                    "photon-steps/s in the kernel alone")
        print(f"{case} path rate: {loop}; {n * len(sim.ts) / wall:.4e} from "
              f"start() ({wall:.3f} s wall); set-up {sim.setup_seconds:.3f} "
              f"s; peak memory {peak / 2 ** 30:.2f} GiB; kernel "
              f"{ft['ms']:.2f} ms per chunk against a bound of "
              f"{ft['bound_ms']:.2f} ms [{card}]", flush=True)
        out[case] = {"fused_launches": launches}
        del sim, st, live, stokes, frame, v, d, e1, purity, speed
        sim2, _, _, _, prof, _, _ = run(True)
        busy, span = device_busy(prof, torch)
        print(f"{case} path device idle share (profiled second run, first to "
              f"last fused_transport kernel): {1 - busy / span:.4f} "
              f"({busy:.1f} ms busy of {span:.1f} ms) [{card}]", flush=True)
        del sim2, prof
    return out



# -- user code (kernel 1i) ----------------------------------------------------

USER_DT = 1e-3
USER_N = 10_000_000      # run_all.py:208-224 kernelstep_drag_fused_1e7
USER_ITERS = 2 * 1024
USER_DRAG = 1e-7         # the drag's loss of speed per iteration
USER_RATE = 0.1          # the decay's rate 0.1 e^-t per unit time
SPEC_N = 10_000_000      # run_all.py:468-490 spectrum_56bin_x2_thermal_1e7
SPEC_ITERS = 4 * 60      # cut from the benchmark's 2048 (the time limit)
SPEC_EDGES = np.exp(np.linspace(-3.0, 4.0, 57))
UPLAN_N, UPLAN_K = 1 << 20, 256


def drag(state, ctx):
    """run_all.py:208-224's exponential drag (KernelStep)."""
    return state.replace(v=state.v * (1.0 - USER_DRAG))


def decay(p):
    """The time-dependent absorber of physicl_tpu/engine.py:258-265
    (ElementwiseStep) keeping each photon's dose, gated by alive so that a
    dead photon's dose stays what its death left."""
    import torch

    u = p.uniform()
    hit = (u < USER_RATE * torch.exp(-p.t) * p.dt) & p.alive
    return {"alive": ~hit, "dose": p.extras["dose"] + hit * p.E}


def moments(p):
    """physicl_tpu/engine.py:367-371's moments, with the dose."""
    r2 = p.rx ** 2 + p.ry ** 2 + p.rz ** 2
    return {"E_total": p.E, "r2": r2, "dose": p.extras["dose"]}


def user_sim(phys, n, dev, iters=USER_ITERS, chunk=1024, seed=0):
    """The user path: UpdateTimeStep(0.001) -> NewtonianKinematics ->
    ScatterIsotropic(A = n = 1e-3) -> KernelStep(drag, elementwise=True) ->
    ElementwiseStep(decay, extras_write=("dose",)) -> ReduceMeasureStep(
    moments, measure_n=True, extras=("dose",)); n photons at E = 1 along +x
    with a zero dose plane. Returns ``(sim, reduce step)``."""
    import torch

    from physicl_tpu_torch.kernels import KernelStep

    light = phys.light
    sim = phys.Simulation(until_t=(iters - 0.5) * USER_DT, seed=seed,
                          chunk_steps=chunk, device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(USER_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                               n=np.double(0.001)))
    sim.add_step(3, KernelStep(drag, elementwise=True))
    sim.add_step(4, phys.ElementwiseStep(decay, extras_write=("dose",)))
    red = phys.ReduceMeasureStep(None, moments,
                                 outputs=("E_total", "r2", "dose"),
                                 measure_n=True, extras=("dose",))
    sim.add_step(5, red)
    bulk = light.generate_photon_state(n, E=1.0, device=dev)
    bulk["extras"] = {"dose": torch.zeros(n, dtype=torch.float32,
                                          device=dev)}
    sim.add_photons(bulk)
    return sim, red


def spectrum_sim(phys, n, dev, iters=SPEC_ITERS, seed=0):
    """run_all.py:468-490: n photons at E = 1 along +x, thermal Compton (A n
    c dt = 1e-3, mec2 = 1e9, theta_e = 0.01), a 56-bin count spectrum with
    the alive count and a 56-bin energy spectrum, both with underflow and
    overflow (116 float and 1 int record columns). Returns ``(sim, counts,
    energies)``."""
    light = phys.light
    c_dt = float(light.c) * USER_DT
    sim = phys.Simulation(until_t=(iters - 0.5) * USER_DT, seed=seed,
                          device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(USER_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterComptonStep(
        A=0.001 / c_dt, n=1.0, mec2=1e9, theta_e=0.01))
    counts = light.SpectrumMeasureStep(None, edges=SPEC_EDGES,
                                       measure_n=True, underflow=True,
                                       overflow=True)
    energies = light.SpectrumMeasureStep(None, edges=SPEC_EDGES,
                                         weight="energy", underflow=True,
                                         overflow=True)
    sim.add_step(3, counts)
    sim.add_step(4, energies)
    sim.add_photons(light.generate_photon_state(n, E=1.0, device=dev))
    return sim, counts, energies


def user_plan_sim(phys, case, dev, n=UPLAN_N, chunk=UPLAN_K, seed=0):
    """The Simulation of one kernel 1i plan (``USER_PLANS``): n photons in
    isotropic directions from a cube of 200 c dt, E in [0.5, 2], w in
    [0.5, 1], with a zero "dose" plane and a 3-row "spin" plane of random
    values; ``chunk`` iterations of dt = 1e-3."""
    import torch

    from physicl_tpu_torch.kernels import KernelStep

    light, newton = phys.light, phys.newton
    c = float(light.c)
    c_dt = c * USER_DT
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_ph = n // 2 if case == "kstate-mixed" else n
    sim = phys.Simulation(until_t=(chunk - 0.5) * USER_DT, seed=seed,
                          chunk_steps=chunk, device=dev, auto_shrink=False)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(USER_DT)))
    sim.add_step(1, newton.NewtonianKinematicsStep())
    steps = []
    if case == "custom":
        steps.append(light.ScatterIsotropicStep(A=0.02 / c_dt, n=1.0))
        steps.append(phys.ElementwiseStep(lambda p: {
            "vx": p.vx * 0.999, "E": p.E * torch.exp(-2.0 * p.dt),
            "w": torch.sqrt(p.w) / (1.0 + p.t)}))
    elif case == "custom-draws":
        def fn(p):
            u1 = p.uniform()
            p.uniform()  # drawn and never used: the next draw shifts
            u3 = p.uniform()
            kill = (u1 < 0.01) & (p.E > 0.6)
            return {"alive": ~kill, "vy": torch.where(u3 < 0.5, -p.vy,
                                                      p.vy)}
        steps.append(light.ScatterIsotropicStep(A=0.02 / c_dt, n=1.0))
        steps.append(phys.ElementwiseStep(fn))
    elif case == "custom-extras":
        def fn(p):
            sx, sy, sz = p.extras["spin"]
            norm = torch.linalg.norm(torch.stack([sx, sy, sz]), dim=0)
            hit = (p.uniform() < 0.05) & p.alive
            return {"dose": p.extras["dose"] + torch.where(hit, p.E, 0.0),
                    "spin": (sy / norm, -sx / norm, sz * 0.99),
                    "alive": ~hit}
        steps.append(phys.ElementwiseStep(fn, extras=("spin",),
                                          extras_write=("dose", "spin")))
    elif case == "reduce-n":
        steps.append(light.ScatterIsotropicStep(A=0.02 / c_dt, n=1.0))
        steps.append(light.ScatterDeleteStep(1.0, 0.002 / c_dt))
        steps.append(phys.ReduceMeasureStep(None, lambda p: {
            "E": p.E, "speed": torch.sqrt(p.vx ** 2 + p.vy ** 2
                                          + p.vz ** 2) / c,
            "fast": (p.vx > 0) & (p.E > 1.0)},
            outputs=("E", "speed", "fast"), measure_n=True))
    elif case == "mesh-x-path":
        steps.append(light.ScatterIsotropicStep(A=0.02 / c_dt, n=1.0))
        steps.append(light.MeshTallyStep(
            None, axis="x", edges=np.linspace(-100, 100, 41) * c_dt,
            value="pathlength", underflow=True, overflow=True))
    elif case == "mesh-r-weighted":
        steps.append(light.ScatterIsotropicStep(A=0.02 / c_dt, n=1.0))
        steps.append(light.ScatterDeleteStep(1.0, 0.005 / c_dt,
                                             implicit_capture=True))
        steps.append(light.MeshTallyStep(
            None, axis="r", edges=np.linspace(0, 150, 31) * c_dt,
            center=(10 * c_dt, 0.0, -5 * c_dt), weighted=True,
            overflow=True, measure_n=True))
    elif case == "kstate-mixed":
        def fn(state, ctx):
            ph = (state.otype == 1).to(torch.float32)
            slow = 1.0 - 1e-4 * (1.0 - ph)
            return state.replace(v=state.v * slow,
                                 w=state.w * (1.0 + 0.01 * ph))
        steps.append(newton.LorentzForceStep(B_field=(0.0, 0.0, 100.0),
                                             q_over_m=1.0))
        steps.append(light.ScatterIsotropicStep(A=0.02 / c_dt, n=1.0))
        steps.append(KernelStep(fn, elementwise=True))
    elif case == "reduce-weighted":
        # run_all.py:494-505 implicit_capture_roulette_1e7's tally
        steps.append(light.ScatterDeleteStep(
            np.double(1.0), np.double(0.05 / c_dt), implicit_capture=True,
            roulette=(0.2, 0.4)))
        steps.append(phys.ReduceMeasureStep(None, lambda p: {"W": p.w},
                                            outputs=("W",), measure_n=True))
    elif case == "past-limits":
        steps.append(light.ScatterIsotropicStep(A=0.02 / c_dt, n=1.0))
        steps.append(phys.ElementwiseStep(past_limits))
    elif case == "fluor-callable":
        # examples/make_fluorescence_nb.py:57, the A(E) callable in torch
        steps.append(light.ScatterDeleteStep(
            n=1.0, A=FLUOR_P / c_dt,
            A_fn=lambda E: (torch.tensor(20.0) / E) ** 3,
            fluorescence=(FLUOR_Y, FLUOR_KA), fluorescence_edge=7.11,
            measure_deposition=True))
    else:
        raise KeyError(case)
    for i, st in enumerate(steps):
        sim.add_step(2 + i, st)
    r = (torch.rand((3, n_ph), generator=gen, device=dev) - 0.5) * 200 * c_dt
    E = (torch.rand(n_ph, generator=gen, device=dev) * 1.5 + 0.5
         if case != "fluor-callable" else FLUOR_E0)
    bulk = light.generate_photon_state(
        n_ph, E=E, r=r, v=isotropic_v(torch, n_ph, c, gen, dev),
        w=torch.rand(n_ph, generator=gen, device=dev) * 0.5 + 0.5,
        device=dev)
    if case == "custom-extras":
        bulk["extras"] = {
            "dose": torch.zeros(n_ph, device=dev),
            "spin": torch.rand((3, n_ph), generator=gen, device=dev) - 0.5}
    sim.add_photons(bulk)
    if case == "kstate-mixed":
        sim.add_particles(newton.generate_particle_state(
            n - n_ph, v=isotropic_v(torch, n - n_ph, c / 3, gen, dev),
            device=dev))
    return sim


USER_PLANS = ("custom", "custom-draws", "custom-extras", "reduce-n",
              "mesh-x-path", "mesh-r-weighted", "kstate-mixed",
              "reduce-weighted", "fluor-callable", "past-limits")


def past_limits(p):
    """An ElementwiseStep past the limits of the port's former in-kernel
    interpreter (48 registers, 64 draws, 1024 instructions a plan): 60
    values live at once, 70 draws and a chain of 1200 operations, written
    into dv (which no later step reads: no feedback between iterations)."""
    vals = [p.E * (i + 1.5) for i in range(60)]
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    u = p.uniform()
    for _ in range(69):
        u = u + p.uniform()
    x = p.w
    for i in range(600):
        x = x * 0.5 + p.E * float(i % 5 + 1)
    return {"dvx": total / 1860.0, "dvy": u, "dvz": x}


def user_plan_sims(phys, dev, n):
    """``{label: Simulation}`` of every kernel 1i plan this script runs
    (``USER_PLANS`` but the field-only one, the user and spectrum paths,
    the deep shield's analog and split_chunk band tallies) at ``n``
    photons on ``dev``: their generated sources depend on the programs,
    not on the population."""
    sims = {case: user_plan_sim(phys, case, dev, n=n, chunk=16)
            for case in USER_PLANS if case != "fluor-callable"}
    sims["user"] = user_sim(phys, n, dev, iters=16, chunk=16)[0]
    sims["spectrum"] = spectrum_sim(phys, n, dev, iters=16)[0]
    for mode in ("analog", "split_chunk"):
        sims[f"shield-{mode}"] = shield_sim(phys, mode, dev, n=n,
                                            cap=4 * n, iters=16)[0]
    return sims


def user_plan_sources(phys):
    """``{label: generated source}`` of every kernel 1i plan of
    ``user_plan_sims``, planned on the CPU."""
    from physicl_tpu_torch.ops import codegen

    sources = {}
    for name, sim in user_plan_sims(phys, "cpu", 1 << 10).items():
        plan = planned(sim)[1].plan
        check(plan.has_user, f"{name}: no user op in {plan.ops}")
        sources[f"{name} {codegen.plan_label(plan)}"] = codegen.plan_source(
            plan)
    return sources


def user_build(plan):
    """``_build.plan_builds``' entry of a user plan's library: its label,
    build seconds and nvcc log ({} where another process built it)."""
    from physicl_tpu_torch.ops import _build, codegen

    return _build.plan_builds.get(_build.plan_key(codegen.plan_source(plan)),
                                  {})


def user_report(F, plan, capacity, k_act):
    """One line on a user plan's generated library: its file, build
    seconds, the instantiation's registers and spills, the blocks per SM
    of a launch at ``capacity`` x ``k_act``, and its programs' SASS
    instructions per photon-iteration (the probe loop,
    ``scripts/sass_loop.py --user``) against their recorded instructions
    (what the interpreter decoded one by one)."""
    sl = sass_loop()
    lib = F._library(plan)
    check(os.path.basename(lib._name).startswith("libfused_plan_")
          and plan.kernel_variant & 40 == 40,
          f"{[op.kind for op in plan.ops]}: variant {plan.kernel_variant} "
          f"does not run a generated library ({lib._name})")
    b = user_build(plan)
    grid = F.kernel_grid(plan, capacity, k_act)
    probe = sl.user_summary(sl.functions(sl.library_sass(lib._name)))
    n_ins = sum(len(op.prog.ins) for op in plan.ops if op.kind in F.USER_OPS)
    return (f"library {os.path.basename(lib._name)}, built in "
            + (f"{b['seconds']:.2f} s" if b else "another process")
            + f"; variant {plan.kernel_variant} "
            f"({kernel_regs(plan.kernel_variant, plan)}); grid {grid} blocks "
            f"({grid / 132:.2f} per SM); user programs {n_ins} recorded "
            f"instructions a photon-iteration, compiled to "
            f"{probe['per_iteration']} SASS instructions ({probe['votes']} "
            f"votes; {probe['classes']})")


def user_plan_phase(torch, phys, F, dev, compare, card, times):
    """Phase: fused_transport against the twin on the kernel 1i plans at
    2**20 slots x 256 iterations, as their providers hand them over (the
    recorded programs in the user instantiation): int records equal, every
    plane (the written-back extras included) bitwise, rec_f within rtol
    1e-5; each timed against its bound, with the instantiation's
    registers."""
    phase(f"fused_transport vs twin on the user-code plans (2**20 slots, "
          f"{UPLAN_K} iterations)")
    for case in USER_PLANS:
        packed, sched, seed, k, plan, starts = first_chunk_inputs(
            user_plan_sim(phys, case, dev), F)
        user = plan.kernel_variant & 40 == 40
        check(user or case == "fluor-callable", f"{case}: variant "
              f"{plan.kernel_variant} is not the user instantiation")
        if user:
            print(f"{case}: {user_report(F, plan, packed.shape[1], k)} "
                  f"[{card}]", flush=True)
        plain_ms = compare(case, packed, sched, k, plan, starts, "user",
                           seed=seed, need_bitwise=True)
        out = torch.empty_like(packed)
        rec = F.fused_transport(packed, out, sched, seed, k, plan)[0]
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: F.fused_transport(packed, out, sched, seed, k,
                                               plan), 5, torch)
        events = expected_events(plan, packed,
                                 float(rec[:k, 0].double().sum()), USER_DT)
        b_ms, b_by = transport_bound(plan, packed.shape[1], k, None, events)
        times[case] = ms
        n_ins = sum(len(op.prog.ins) for op in plan.ops
                    if op.kind in F.USER_OPS)
        print(f"{case} at 2**20 x {k}: kernel {ms:.3f} ms, twin "
              f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); ops "
              f"{[op.kind for op in plan.ops]}, {n_ins} user instructions, "
              f"extras {plan.extras}, write-back {plan.extras_writeback}, "
              f"variant {plan.kernel_variant} "
              f"({kernel_regs(plan.kernel_variant, plan)}) [{card}]",
              flush=True)
        del packed, out


def user_paths(torch, phys, F, dev, card, uft, sft):
    """Phases: the user path (10**7 photons x 2048 iterations) and the
    spectrum path (10**7 x SPEC_ITERS) through Simulation, each run twice
    (the second profiled), with their physics gates; returns each first
    run's launches."""
    dev = torch.device(dev)
    out = {}
    for case, n, iters, ft in (("user", USER_N, USER_ITERS, uft),
                               ("spectrum", SPEC_N, SPEC_ITERS, sft)):
        phase(f"{case} path: {n} photons, {iters} iterations")

        def run(profile):
            F.fused_transport.launches = 0
            built = (user_sim(phys, n, dev) if case == "user"
                     else spectrum_sim(phys, n, dev))
            wall, prof, peak = run_sim(torch, built[0], profile)
            return built, wall, prof, peak, F.fused_transport.launches

        built, wall, _, peak, launches = run(False)
        sim = built[0]
        text = sim.explain_plan()
        print(text)
        chunks = [k for _, k, _ in sim.chunk_log]
        check(sim.used_fused and len(sim.ts) == iters
              and launches == len(chunks) and launches >= 2,
              f"{case}: launches {launches}, chunks {chunks}")
        st = sim.sim_state
        alive = st.alive[:n]
        if case == "user":
            what = user_gates(torch, sim, built[1], st, n, iters)
            per_iter = np.asarray(built[1].data, np.float64)[:, 1]
        else:
            what = spectrum_gates(torch, sim, built[1], built[2], st, n)
            per_iter = np.asarray(built[1].data, np.float64)[:, 1]
        print(f"{case} path: {len(sim.ts)} iterations in chunks {chunks}, "
              f"fused_transport launches {launches}; {what}")
        rate, steady_s = steady_rate(sim, per_iter)
        print(f"{case} path rate: {rate:.4e} alive photon-steps/s over the "
              f"dispatch loop after the first chunk, device clock "
              f"({steady_s * 1e3:.1f} ms); {float(per_iter.sum()) / wall:.4e}"
              f" from start() ({wall:.3f} s wall); set-up "
              f"{sim.setup_seconds:.3f} s; peak memory {peak / 2 ** 30:.2f} "
              f"GiB; kernel {ft['ms']:.2f} ms per chunk against a bound of "
              f"{ft['bound_ms']:.2f} ms ({ft['bound_by']}) [{card}]",
              flush=True)
        out[case] = {"fused_launches": launches}
        del sim, st, alive, built
        built2, _, prof, _, _ = run(True)
        busy, span = device_busy(prof, torch)
        print(f"{case} path device idle share (profiled second run, first to "
              f"last fused_transport kernel): {1 - busy / span:.4f} "
              f"({busy:.1f} ms busy of {span:.1f} ms) [{card}]", flush=True)
        del built2, prof
    return out


def user_gates(torch, sim, red, st, n, iters):
    """The user path's laws: every alive |v| between c (1 - 1e-7)**K and c
    to float32; E_total = n and the alive photons' dose 0 in every row; the
    written-back dose plane sums to N0 - n; the survivors within 5 sigma of
    prod(1 - p_k), p_k the 24-bit uniform's chance of u < 0.1 e**-t_k
    dt."""
    rows = np.asarray(red.data, np.float64)
    check(rows.shape == (iters, 5), f"user: rows {rows.shape}")
    n_rows = rows[:, 1]
    check(bool((rows[:, 2] == n_rows).all()), "user: E_total differs from "
          "the alive count")
    check(bool((rows[:, 4] == 0).all()), "user: alive photons carry dose")
    alive = st.alive[:n]
    n_end = int(alive.sum())
    dose = float(st.extras["dose"].double().sum())
    check(dose == n - n_end and n_rows[-1] == n_end,
          f"user: dose sum {dose} against N0 - n = {n - n_end}")
    speed = torch.linalg.vector_norm(st.v[:, :n][:, alive].double(), dim=0)
    lo = C_LIGHT * (1 - USER_DRAG) ** iters * (1 - 1e-6)
    hi = C_LIGHT * (1 + 1e-6)
    s_lo, s_hi = float(speed.min()), float(speed.max())
    check(lo <= s_lo and s_hi <= hi, f"user: |v| in [{s_lo}, {s_hi}] "
          f"outside [{lo}, {hi}]")
    ts = np.asarray(sim.ts, np.float64)
    x = (np.float32(USER_RATE) * np.exp(-ts.astype(np.float32))
         .astype(np.float32) * np.float32(USER_DT)).astype(np.float64)
    p = np.ceil(x * 2 ** 24) * 2.0 ** -24
    q = np.cumprod(1 - p)
    sigma = np.sqrt(n * q * (1 - q))
    z = float(np.max(np.abs(n_rows - n * q) / np.maximum(sigma, 1.0)))
    check(z <= 5, f"user: survivors {z:.2f} sigma off prod(1 - p_k)")
    return (f"E_total = n and alive dose 0 in all {iters} rows; dose plane "
            f"sum {dose:.0f} = N0 - n; |v| in [{s_lo:.6f}, {s_hi:.6f}] "
            f"within [{lo:.6f}, {hi:.6f}]; survivors {n_end} within {z:.2f} "
            "sigma of prod(1 - p_k)")


def spectrum_gates(torch, sim, counts, energies, st, n):
    """The spectrum path's laws: the bins and the capture bins sum to n in
    every row; the last row equals a histogram of the final planes exactly
    (the same float32 edges); the energy bins sum to the alive energy
    within rtol 1e-5."""
    c = np.asarray(counts.data, np.float64)
    e = np.asarray(energies.data, np.float64)
    nb = len(SPEC_EDGES) + 1  # 56 bins, underflow, overflow
    check(c.shape[1] == 2 + nb and e.shape[1] == 1 + nb,
          f"spectrum: rows {c.shape} {e.shape}")
    check(bool((c[:, 2:].sum(1) == c[:, 1]).all()), "spectrum: the bins do "
          "not sum to n")
    alive = st.alive[:n]
    E = st.E[:n][alive]
    edges = torch.tensor(SPEC_EDGES, dtype=torch.float32, device=E.device)
    idx = torch.searchsorted(edges, E.contiguous(), right=True)
    # 0: underflow, 1..56: the bins, 57: overflow
    hist = torch.bincount(idx, minlength=nb).double().cpu().numpy()
    want = np.concatenate([hist[1:-1], hist[:1], hist[-1:]])
    check(bool((c[-1, 2:] == want).all()), "spectrum: the last row differs "
          "from a histogram of the final planes")
    total = float(E.double().sum())
    rel = abs(float(e[-1, 1:].sum()) - total) / total
    check(rel <= 1e-5, f"spectrum: energy bins {e[-1, 1:].sum()} against "
          f"the alive energy {total} ({rel:.2e})")
    return (f"bins + capture bins = n in every row; last row = the final "
            f"planes' histogram ({int(want.sum())} photons, underflow "
            f"{int(want[-2])}, overflow {int(want[-1])}); energy bins within "
            f"{rel:.2e} of the alive energy")


# -- recorded fields and inverse CDFs, the generic scatter family, shrink ------

MIR_N = 10_000_000       # examples/make_lorentz_nb.py:98-112 at 10**7
MIR_DT = 1e-3
MIR_UNTIL = 0.9999       # 1000 iterations, as the example
MIR_L, MIR_B0 = 2.0, 100.0
MIR_CHUNK = 256          # the Lorentz paths' chunk (run_all.py:27)
MIR_VTOL = 3e-5          # |v| drift: the constant pure-B phase's gate
PHF_N = 10_000_000       # bench.py's workload, the phase function for iso
PHF_ITERS = 1024
PHF_CHUNK = 256
PHF_A = 0.6              # tests/test_phase.py's linear law: <mu> = a / 3
PHF_LAW_N = 1 << 20
GSC_N = 10_000_000       # run_all.py:439-450 and :391-413 on both tiers
GSC_ITERS = 64
GSC_CHUNK = 16
SHR_N = 10_000_000       # the extinction run at 10**7
SHR_P = 0.002            # absorption per iteration: shrinks over ~30 chunks
SHR_CHUNK = 256
RG_C, RG_K = 1 << 20, 256  # the new plans against the twin


def mirror_B(rx, ry, rz):
    """The example's axial mirror: Bz = B0 (1 + z**2 / L**2), Br = -(r / 2)
    dBz / dz."""
    fac = MIR_B0 / (MIR_L * MIR_L)
    return (-fac * rx * rz, -fac * ry * rz,
            MIR_B0 * (1.0 + (rz / MIR_L) ** 2))


def crossed_EB(torch):
    """A plan whose E and B are both callable (a constant component among
    them): ``(E_field, B_field)``."""
    def E(rx, ry, rz):
        return (2.0 * torch.cos(rx * 3.0), 0.5, 0 * rz)

    def B(rx, ry, rz):
        return (ry * 0.5, 1.0 + 0 * rx, 30.0 / (1.0 + rz * rz))
    return E, B


def linear_icdf(u):
    """tests/test_phase.py's exact inverse CDF of (1 + a mu) / 2."""
    import torch

    disc = 1.0 - PHF_A * (2.0 - PHF_A - 4.0 * u)
    return (torch.sqrt(torch.clamp(disc, min=0.0)) - 1.0) / PHF_A


def hg_icdf(u):
    """The Henyey-Greenstein inverse CDF at g = 0.7 as a callable (an
    integer power and divides)."""
    g = 0.7
    s = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
    return (1.0 + g * g - s ** 2) / (2.0 * g)


def prog_ops(spec):
    """float32 operations of one evaluation of a recorded expression
    program: each operation it asks for (a divide or root 8, a
    transcendental or powf 20, an integer power its products), constants
    and variables free; the interpreter's fetch and dispatch are not the
    program's work."""
    from physicl_tpu_torch.ops import fields as FL

    n = 0
    for code, val in spec["prog"]:
        if code in (FL.INS_CONST, FL.INS_VAR):
            continue
        if code in (FL.INS_DIV, FL.INS_SQRT):
            n += 8
        elif code in (FL.INS_POW, FL.INS_EXP, FL.INS_LOG, FL.INS_LOG10,
                      FL.INS_SIN, FL.INS_COS, FL.INS_TAN):
            n += 20
        elif code == FL.INS_IPOW:
            e = abs(int(val))
            n += max(e.bit_length() + bin(e).count("1") - 2, 0) + (
                8 if val < 0 else 0)
        else:
            n += 1
    return n


def mirror_sim(phys, n, dev, iters=None, chunk=MIR_CHUNK, seed=1,
               fields=None):
    """The example's bulk mirror run: n particles from the origin with
    N(0, 1) velocity components (a seeded generator on the card),
    q/m = 1, dt = 1e-3, until_t 0.9999 (or ``iters`` iterations). Returns
    ``(sim, initial |v|)``."""
    import torch

    newton = phys.newton
    until = MIR_UNTIL if iters is None else (iters - 0.5) * MIR_DT
    sim = phys.Simulation(until_t=until, seed=seed, chunk_steps=chunk,
                          device=dev)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(MIR_DT)))
    E, B = fields or (None, mirror_B)
    sim.add_step(1, newton.LorentzForceStep(E_field=E, B_field=B,
                                            q_over_m=1.0))
    sim.add_step(2, newton.NewtonianKinematicsStep())
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((3, n), generator=gen, device=dev)
    r = None
    if fields is not None:  # off the origin: the fields vary over the run
        r = torch.randn((3, n), generator=gen, device=dev) * 0.1
    sim.add_particles(newton.generate_particle_state(n, v=v, r=r,
                                                     device=dev))
    return sim, torch.linalg.vector_norm(v.double(), dim=0)


def phase_sim(phys, n, dev, icdf=linear_icdf, iters=PHF_ITERS,
              chunk=PHF_CHUNK, seed=0, fuse="auto"):
    """bench.py's workload with ScatterPhaseFunctionStep(A = n = 1e-3,
    cos_theta_icdf=icdf) in place of the isotropic scatter. Returns
    ``(sim, sign tally)``."""
    light = phys.light
    sim = phys.Simulation(until_t=(iters - 0.5) * 0.001, seed=seed,
                          chunk_steps=chunk, device=dev, fuse=fuse)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterPhaseFunctionStep(
        A=np.double(0.001), n=np.double(0.001), cos_theta_icdf=icdf))
    sign = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, sign)
    sim.add_photons(light.generate_photon_state(n, E=1.0, device=dev))
    return sim, sign


def wide_sim(phys, n, dev, chunk=RG_K):
    """A plan past every old table limit: 17 ops, 9 distinct fields (eight
    C-expression densities, an A(E) expression), 71 expression
    instructions."""
    light = phys.light
    c_dt = float(light.c) * 0.001
    sim = phys.Simulation(until_t=(chunk - 0.5) * 0.001, seed=4,
                          chunk_steps=chunk, device=dev, auto_shrink=False)
    steps = [phys.UpdateTimeStep(lambda s: np.double(0.001)),
             phys.newton.NewtonianKinematicsStep()]
    for k in range(8):
        steps.append(light.ScatterIsotropicStep(
            A=0.002 / c_dt, variable_n=True,
            variable_n_fn=f"1.0 + 0.25 * cos(r{k % 3}[gid] * {k + 1}e-6)"))
    steps.append(light.ScatterDeleteStep(
        np.double(1.0), np.double(0.001 / c_dt),
        A_fn="pow(E[gid], -1.5) * 0.5 + 0.5"))
    for g in (0.1, 0.3, 0.5, 0.7, -0.2, -0.4):
        steps.append(light.ScatterHenyeyGreensteinStep(A=0.002 / c_dt,
                                                       n=1.0, g=g))
    steps.append(light.ScatterSignMeasureStep(None, True))
    for i, st in enumerate(steps):
        sim.add_step(i, st)
    sim.add_photons(light.generate_photon_state(n, E=1.0, device=dev))
    return sim


def recorded_plan_phase(torch, phys, F, dev, compare, card, times):
    """Phase: fused_transport against the twin on the new plans at 2**20
    slots x 256 iterations, as their providers hand them over (the mirror's
    recorded B, recorded E and B with a constant component, the two
    recorded inverse CDFs, the wide plan): int records equal, planes
    bitwise; each timed against its bound."""
    phase(f"fused_transport vs twin on the recorded-field and wide plans "
          f"(2**20 slots, {RG_K} iterations)")
    sims = {
        "mirror-B": (lambda: mirror_sim(phys, RG_C, dev, iters=RG_K,
                                        chunk=RG_K)[0], "mirror"),
        "recorded-E-B": (lambda: mirror_sim(
            phys, RG_C, dev, iters=RG_K, chunk=RG_K,
            fields=crossed_EB(torch))[0], "recorded-E-B"),
        "phase-icdf-linear": (lambda: phase_sim(
            phys, RG_C, dev, iters=RG_K, chunk=RG_K)[0], "phase-icdf"),
        "phase-icdf-hg": (lambda: phase_sim(
            phys, RG_C, dev, icdf=hg_icdf, iters=RG_K, chunk=RG_K)[0],
            "phase-icdf-hg"),
        "wide-17-ops-9-fields": (lambda: wide_sim(phys, RG_C, dev), "wide"),
    }
    for name, (make, path) in sims.items():
        packed, sched, seed, k, plan, _ = first_chunk_inputs(make(), F)
        check(k == RG_K and plan.has_fields, f"{name}: plan {k} iterations, "
              f"fields {plan.has_fields}")
        specs, _ = F.plan_fields(plan.ops)
        n_ins = sum(len(sp["prog"]) for sp in specs if sp["kind"] == "expr")
        if name.startswith("wide"):
            check(len(plan.ops) >= 17 and len(specs) == 9 and n_ins >= 65,
                  f"{name}: {len(plan.ops)} ops, {len(specs)} fields, "
                  f"{n_ins} instructions")
        plain_ms = compare(name, packed, sched, k, plan, None, path, seed,
                           need_bitwise=True)
        res = torch.empty_like(packed)
        rec = F.fused_transport(packed, res, sched, seed, k, plan)[0]
        ms = cuda_ms(lambda: F.fused_transport(packed, res, sched, seed, k,
                                               plan), 5, torch)
        events = expected_events(plan, packed,
                                 float(rec[:k, 0].double().sum()),
                                 float(sched[0, 0]))
        b_ms, b_by = transport_bound(plan, packed.shape[1], k, None, events)
        times[name] = ms
        print(f"{name} at 2**20 x {k}: ops {[op.kind for op in plan.ops]}, "
              f"{len(specs)} fields, {n_ins} expression instructions; "
              f"variant {plan.kernel_variant} "
              f"({kernel_regs(plan.kernel_variant)}); kernel {ms:.3f} ms, "
              f"twin {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) "
              f"[{card}]", flush=True)
        del packed, res


def mirror_path(torch, phys, F, dev, card, compare):
    """Phase: the magnetic mirror at 10**7 particles: its first chunk
    against the twin, then the run through Simulation: the fused tier with
    the recorded B; |v| kept to the constant pure-B gate; the rate.
    Returns the entry, the launches and the rate."""
    entry = path_chunk0("mirror-chunk-0", mirror_sim(phys, MIR_N, dev)[0],
                        F, torch, compare, "mirror", card, ["lorentz", "kin"],
                        streams=False)
    phase(f"magnetic mirror: {MIR_N} particles in a recorded B(r), "
          f"{int(MIR_UNTIL / MIR_DT) + 1} iterations in chunks of "
          f"{MIR_CHUNK}")
    F.fused_transport.launches = 0
    sim, v0 = mirror_sim(phys, MIR_N, dev)
    wall, _, peak = run_sim(torch, sim)
    launches = F.fused_transport.launches
    check(sim.used_fused and launches >= 4, f"mirror: fused "
          f"{sim.used_fused}, launches {launches}\n{sim.explain_plan()}")
    print(sim.explain_plan())
    st = sim.sim_state
    v = torch.linalg.vector_norm(st.v[:, :MIR_N].double(), dim=0)
    drift = float((v / v0 - 1).abs().max())
    z = st.r[2, :MIR_N].abs()
    check(bool(st.alive[:MIR_N].all()) and bool(torch.isfinite(st.r).all()),
          "mirror: particles lost or non-finite")
    check(drift <= MIR_VTOL, f"mirror: |v| drifted by {drift:.2e} (the "
          f"constant pure-B gate {MIR_VTOL:.0e})")
    rate, steady_s = steady_rate(sim, np.full(len(sim.ts), MIR_N))
    print(f"mirror path: {len(sim.ts)} iterations, fused_transport launches "
          f"{launches}; max relative |v| drift {drift:.3e} (gate "
          f"{MIR_VTOL:.0e}, the constant pure-B phase's); max |z| "
          f"{float(z.max()):.3f}; rate {rate:.4e} particle-steps/s over the "
          f"dispatch loop after the first chunk ({steady_s * 1e3:.1f} ms of "
          f"device time), {MIR_N * len(sim.ts) / wall:.4e} from start() "
          f"({wall:.2f} s wall, set-up {sim.setup_seconds:.3f} s, peak "
          f"{peak / 2 ** 30:.2f} GiB); kernel {entry['ms']:.2f} ms per chunk "
          f"against a bound of {entry['bound_ms']:.2f} ms "
          f"({entry['bound_by']}) [{card}]", flush=True)
    del sim, st, v, v0, z
    return entry, launches, rate


def phase_function_path(torch, phys, F, dev, card, compare):
    """Phase: the forced-scatter law of a recorded inverse CDF, then
    bench.py's workload with it at 10**7 photons: its first chunk against
    the twin, then the run through Simulation. Returns the entry, the
    launches and the rate."""
    phase(f"callable phase function: one forced scatter and 8 iterations "
          f"at {PHF_LAW_N} photons")
    c = float(phys.light.c)
    sim = phys.Simulation(until_t=0.5 * 0.001, seed=0, device=dev)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, phys.light.ScatterPhaseFunctionStep(
        A=1.0 / (c * 0.001), n=1.0, cos_theta_icdf=linear_icdf))
    sim.add_photons(phys.light.generate_photon_state(PHF_LAW_N, E=1.0,
                                                     device=dev))
    run_sim(torch, sim)
    check(sim.used_fused, "the recorded inverse CDF did not fuse")
    v = sim.sim_state.v[:, :PHF_LAW_N].double()
    speed = torch.linalg.vector_norm(v, dim=0)
    mu = v[0] / speed
    z = abs(float(mu.mean()) - PHF_A / 3) / (float(mu.std())
                                            / np.sqrt(PHF_LAW_N))
    s_err = float((speed / c - 1).abs().max())
    check(z < 5 and s_err < 3e-5, f"phase law: <mu> {float(mu.mean()):.5f} "
          f"against a/3 = {PHF_A / 3:.5f} ({z:.2f} sigma), |v| off c by "
          f"{s_err:.2e}")
    print(f"phase law: one forced scatter of {PHF_LAW_N} photons, <mu> = "
          f"{float(mu.mean()):.6f} against a/3 = {PHF_A / 3:.6f} "
          f"({z:.2f} sigma); |v| = c within {s_err:.2e}", flush=True)
    del sim, v, speed, mu
    # the beam's mean direction along +x: each scatter multiplies it by
    # <mu> = a / 3 (an axially symmetric law), so after K iterations it is
    # (1 - p (1 - a / 3))**K, p the kernel's collision probability (the
    # 24-bit uniform's floor(pcoll 2**24) + 1 steps of 2**-24)
    pcoll = float(np.float32(np.float32(0.001 * 0.001)
                             * np.float32(c * 0.001)))
    p = (np.floor(pcoll * 2 ** 24) + 1) * 2.0 ** -24
    sim, _ = phase_sim(phys, PHF_LAW_N, dev, iters=8, chunk=8)
    run_sim(torch, sim)
    ux = sim.sim_state.v[0, :PHF_LAW_N].double() / c
    want = (1 - p * (1 - PHF_A / 3)) ** 8
    zx = abs(float(ux.mean()) - want) / (float(ux.std())
                                         / np.sqrt(PHF_LAW_N))
    check(sim.used_fused and zx < 5, f"phase law: <v_x> / c = "
          f"{float(ux.mean()):.6f} after 8 iterations against (1 - p (1 - "
          f"a/3))**8 = {want:.6f} ({zx:.2f} sigma)")
    print(f"phase law: <v_x> / c = {float(ux.mean()):.6f} after 8 "
          f"iterations at p = {p:.6f} against (1 - p (1 - a/3))**8 = "
          f"{want:.6f} ({zx:.2f} sigma)", flush=True)
    del sim, ux

    entry = path_chunk0("phase-chunk-0", phase_sim(phys, PHF_N, dev)[0], F,
                        torch, compare, "phase-icdf", card,
                        ["kin", "phase", "sign"], streams=False)
    phase(f"callable phase function: {PHF_N} photons x {PHF_ITERS} "
          "iterations through Simulation")
    F.fused_transport.launches = 0
    sim, sign = phase_sim(phys, PHF_N, dev)
    wall, _, peak = run_sim(torch, sim)
    launches = F.fused_transport.launches
    check(sim.used_fused and launches >= 4, f"phase path: fused "
          f"{sim.used_fused}, launches {launches}")
    data = np.asarray(sign.data)
    check(data.shape == (PHF_ITERS, 5) and bool((data[:, 1] == PHF_N).all()),
          f"phase path: records {data.shape}, photons lost")
    # the +x share after k iterations: after m >= 1 scatters the direction
    # density in mu = cos(angle to +x) is 1/2 + (3/2) (a/3)**m mu (the
    # linear law has Legendre moments 1 and a/3 only, and they multiply
    # scatter by scatter), so P(v_x > 0) = 1/2 + (3/4) (a/3)**m; summed
    # over m ~ Binomial(k, p)
    k = np.arange(1, PHF_ITERS + 1)
    q0 = (1 - p) ** k
    share = q0 + 0.5 * (1 - q0) + 0.75 * ((1 - p * (1 - PHF_A / 3)) ** k
                                          - q0)
    zs = np.abs(data[:, 2] - PHF_N * share) / np.sqrt(
        PHF_N * share * (1 - share) + 1)
    worst = float(zs.max())
    s_err = float((torch.linalg.vector_norm(
        sim.sim_state.v[:, :PHF_N].double(), dim=0) / c - 1).abs().max())
    check(worst < 5 and s_err < 3e-5, f"phase path: +x share off its law "
          f"by {worst:.2f} sigma at iteration {int(zs.argmax()) + 1} (count "
          f"{int(data[zs.argmax(), 2])} against "
          f"{PHF_N * share[zs.argmax()]:.1f}), |v| off c by {s_err:.2e}")
    rate, steady_s = steady_rate(sim, np.full(PHF_ITERS, PHF_N))
    print(f"phase path: {PHF_ITERS} iterations in {len(sim.chunk_log)} "
          f"chunks, fused_transport launches {launches}; the +x share of "
          f"every iteration within {worst:.2f} binomial sigma of its law "
          f"(iteration 1: {data[0, 2] / PHF_N:.6f} against {share[0]:.6f}, "
          f"iteration 16: {data[15, 2] / PHF_N:.6f} against "
          f"{share[15]:.6f}); |v| = c within {s_err:.2e}; rate "
          f"{rate:.4e} photon-steps/s over the "
          f"dispatch loop after the first chunk ({steady_s * 1e3:.1f} ms), "
          f"{PHF_N * PHF_ITERS / wall:.4e} from start() ({wall:.2f} s wall, "
          f"peak {peak / 2 ** 30:.2f} GiB); kernel {entry['ms']:.2f} ms per "
          f"chunk against {entry['bound_ms']:.2f} ms ({entry['bound_by']}) "
          f"[{card}]", flush=True)
    del sim
    return entry, launches, rate


def gsc_sim(phys, case, dev, fuse):
    """run_all.py:439-450 (compton_kn_1e7, with its sign tally) and
    :391-413 (polarized_rayleigh, with a Stokes tally) on ``fuse``'s tier,
    GSC_ITERS iterations in chunks of GSC_CHUNK. Returns ``(sim, tally)``."""
    light, pol = phys.light, phys.polarization
    sim = phys.Simulation(until_t=(GSC_ITERS - 0.5) * 0.001, seed=0,
                          chunk_steps=GSC_CHUNK, device=dev, fuse=fuse)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    if case == "compton":
        sim.add_step(2, light.ScatterComptonStep(
            A=0.001 / (float(light.c) * 1e-3), n=1.0, mec2=1.0,
            kn_cross_section=True))
        tally = light.ScatterSignMeasureStep(None, True)
        sim.add_photons(light.generate_photon_state(GSC_N, E=1.0,
                                                    device=dev))
    else:
        sim.add_step(2, pol.ScatterPolarizedRayleighStep(
            A=np.double(0.001), n=np.double(0.001)))
        tally = pol.StokesMeasureStep(None)
        # linearly polarized: the Stokes means move with each scatter
        sim.add_photons(pol.polarized_photon_state(
            GSC_N, E=1.0, stokes=(1.0, 0.0, 0.0), device=dev))
    sim.add_step(3, tally)
    return sim, tally


def generic_scatter_paths(torch, phys, F, dev, card):
    """Phase: the Compton and polarized Rayleigh workloads under
    fuse="off" at 10**7 photons, held within 5 sigma of the same plan
    fused; prints both tiers' rates."""
    out = {}
    for case in ("compton", "polarized"):
        phase(f"generic {case} workload: {GSC_N} photons x {GSC_ITERS} "
              "iterations, fuse='off' against fused")
        runs = {}
        for fuse in ("off", "auto"):
            F.fused_transport.launches = 0
            sim, tally = gsc_sim(phys, case, dev, fuse)
            wall, _, peak = run_sim(torch, sim)
            launches = F.fused_transport.launches
            check(sim.used_fused == (fuse == "auto")
                  and (launches > 0) == (fuse == "auto"),
                  f"{case} {fuse}: fused {sim.used_fused}, launches "
                  f"{launches}")
            rate, steady_s = steady_rate(sim, np.full(GSC_ITERS, GSC_N))
            st = sim.sim_state
            obs = {"vx": st.v[0, :GSC_N].double() / float(phys.light.c),
                   "E": st.E[:GSC_N].double()}
            if case == "polarized":
                sk = st.extras["stokes"][:, :GSC_N].double()
                obs.update(Q=sk[0], U=sk[1], V=sk[2],
                           p=torch.linalg.vector_norm(sk, dim=0))
            runs[fuse] = ({k: (float(v.mean()), float(v.var()))
                           for k, v in obs.items()},
                          np.asarray(tally.data, np.float64), rate, wall,
                          launches)
            print(f"{case} ({'generic' if fuse == 'off' else 'fused'}): "
                  f"rate {rate:.4e} photon-steps/s over the dispatch loop "
                  f"after the first chunk ({steady_s * 1e3:.1f} ms of device "
                  f"time), wall {wall:.2f} s, peak {peak / 2 ** 30:.2f} GiB, "
                  f"fused_transport launches {launches} [{card}]", flush=True)
            del sim, st, obs
        (ga, gr, g_rate, _, _), (fa, fr, f_rate, _, _) = runs["off"], \
            runs["auto"]
        # the degree of polarization stays 1 to rounding (the dipole matrix
        # keeps a pure state pure): its spread is rounding, not sampling,
        # so it is held to 1 and left out of the sigma comparison
        if case == "polarized":
            check(1 - ga["p"][0] < 1e-6 and 1 - fa["p"][0] < 1e-6,
                  f"{case}: mean purity {ga['p'][0]} (generic), "
                  f"{fa['p'][0]} (fused)")
        worst, z = 0.0, {}
        for k in ga:
            if k == "p":
                continue
            se = np.sqrt((ga[k][1] + fa[k][1]) / GSC_N)
            z[k] = abs(ga[k][0] - fa[k][0]) / max(se, 1e-300)
            worst = max(worst, z[k])
        check(gr.shape == fr.shape, f"{case}: tallies {gr.shape} {fr.shape}")
        if case == "compton":  # n and the +x, +y, +z counts, binomial
            s_ = fr[:, 2:5] / GSC_N
            zc = np.abs(gr[:, 2:5] - fr[:, 2:5]) / np.sqrt(
                2 * GSC_N * s_ * (1 - s_) + 1)
            worst = max(worst, float(zc.max()))
            check(bool((gr[:, 1] == GSC_N).all() and (fr[:, 1] == GSC_N)
                       .all()), f"{case}: photons lost")
        check(worst < 5, f"{case}: generic and fused differ by {worst:.2f} "
              "sigma")
        what = ("final-state means and per-iteration counts"
                if case == "compton" else "final-state means")
        print(f"{case}: generic and fused agree within {worst:.2f} sigma "
              f"({what}; " + ", ".join(f"{k} {v:.2f}" for k, v in z.items())
              + (f"; purity 1 - {1 - ga['p'][0]:.2e} and 1 - "
                 f"{1 - fa['p'][0]:.2e}" if case == "polarized" else "")
              + "); "
              f"the generic tier at {g_rate:.4e} against the fused "
              f"{f_rate:.4e} photon-steps/s ({f_rate / g_rate:.1f}x) [{card}]",
              flush=True)
        out[case] = {"generic_rate": g_rate, "fused_rate": f_rate,
                     "fused_launches": runs["auto"][4]}
    return out


def shrink_path(torch, phys, F, dev, card, compare):
    """Phase: an extinction run at 10**7 photons at the default
    auto_shrink: the capacity after each shrink, the first chunk at each
    shrunk capacity against the twin, and each chunk's device time and
    alive photon-steps/s before and after."""
    from physicl_tpu_torch.state import pad_capacity

    phase(f"shrink: {SHR_N} photons absorbed at {SHR_P} per iteration, "
          f"extinction exit, chunks of {SHR_CHUNK}")
    light = phys.light
    sim = phys.Simulation(exit="extinction", seed=5, chunk_steps=SHR_CHUNK,
                          device=dev)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterDeleteStep(
        np.double(SHR_P / (float(light.c) * 0.001)), np.double(1.0)))
    meas = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, meas)
    sim.add_photons(light.generate_photon_state(SHR_N, E=1.0, device=dev))
    check(sim.auto_shrink, "auto_shrink is not the default")
    # the first launch at each capacity below the start's, its inputs
    # copied as the provider hands them over (a copy of at most 278,528
    # slots, on the stream before the launch)
    cap0, shrunk, launch = pad_capacity(SHR_N), {}, F.fused_chunk

    def recorded(packed, sched, seed, k_act, plan, out=None,
                 emit_starts=None):
        cap = packed.shape[1]
        if cap < cap0 and cap not in shrunk:
            shrunk[cap] = (packed.clone(), sched.clone(), seed, k_act, plan)
        return launch(packed, sched, seed, k_act, plan, out=out,
                      emit_starts=emit_starts)

    F.fused_transport.launches = 0
    F.fused_chunk = recorded
    try:
        wall, _, _ = run_sim(torch, sim)
    finally:
        F.fused_chunk = launch
    launches = F.fused_transport.launches
    shrinks = [e for e in sim.population_log if e[0] == "shrink"]
    # the shrink waits for the alive mirror, which lags the pipeline by
    # the chunks in flight (as in the JAX package)
    check(sim.used_fused and len(shrinks) >= 1
          and all(e[3] < e[2] for e in shrinks),
          f"shrink: {shrinks}, fused {sim.used_fused}")
    n = np.asarray(meas.data)[:, 1]
    k = np.arange(1, len(n) + 1)
    q = (1 - SHR_P) ** k
    z = float(np.max(np.abs(n - SHR_N * q) / np.sqrt(SHR_N * q * (1 - q)
                                                     + 1)))
    check(z < 5 and n[-1] == 0, f"shrink: survivors {z:.2f} sigma off "
          f"(1 - p)**k, last row {n[-1]}")
    # chunk i (i >= 1, timed between the events after chunks i - 1 and i)
    # runs at the capacity of the last shrink before it
    caps = {e[1]: e[3] for e in shrinks}
    cap, rows, first = cap0, [], sim.chunk_log[0][1]
    for i in range(1, len(sim.chunk_log)):
        cap = caps.get(i, cap)
        kk = sim.chunk_log[i][1]
        ms = sim.chunk_log[i - 1][2].elapsed_time(sim.chunk_log[i][2])
        steps = float(n[first:first + kk].sum())
        first += kk
        rows.append((i, cap, kk, ms, steps / max(ms, 1e-9) * 1e3))
    print(f"shrink: capacities {[(e[1], e[2], e[3]) for e in shrinks]} "
          f"(chunk index, before, after); survivors within {z:.2f} sigma of "
          f"(1 - p)**k; extinct after {len(n)} iterations in {launches} "
          f"launches, wall {wall:.2f} s [{card}]")
    for i, cap_i, kk, ms, rate in rows:
        print(f"  chunk {i}: {cap_i} slots, {kk} iterations, {ms:.3f} ms of "
              f"device time, {rate:.4e} alive photon-steps/s", flush=True)
    del sim
    check(sorted(shrunk) == sorted(e[3] for e in shrinks),
          f"shrink: launches at {sorted(shrunk)} slots, shrinks to "
          f"{[e[3] for e in shrinks]}")
    for cap_i, (packed, sched, seed, k_act, plan) in sorted(shrunk.items()):
        check([op.kind for op in plan.ops] == ["kin", "del", "sign"],
              f"shrink: plan {[op.kind for op in plan.ops]} at {cap_i}")
        ms = compare(f"shrink-{cap_i}", packed, sched, k_act, plan, None,
                     "shrink", seed, need_bitwise=True)
        print(f"shrink: the first chunk at {cap_i} slots ({k_act} "
              f"iterations, variant {plan.kernel_variant}) equals the twin "
              f"(twin {ms:.1f} ms) [{card}]", flush=True)
    return {"shrinks": shrinks, "chunks": rows, "launches": launches}


# -- mid-run edits, the spatial sort, checkpoints, the kernel bridge and ----
# -- profiling ----------------------------------------------------------------

INJ_N = 10_000_000       # bench.py's width
INJ_ADD = 1 << 20        # photons injected from the measure step's collect
INJ_CHUNK = 1024
INJ_CHUNKS = 10          # the injection lands after chunk 6 (depth 4)
TWIN_N = 1 << 16         # the card-against-CPU runs
TWIN_CHUNK = 32
TWIN_ITERS_RUN = 256     # eight chunks
SORT_N = 10_000_000      # the locality-free media case at bench.py's width
SORT_CHUNK = 256
SORT_ITERS = 4 * SORT_CHUNK
BRIDGE_N = 1 << 20


def timed_launches(F, torch, keep_cap=None):
    """Wrap ``F.fused_chunk`` (undo with the returned ``restore``): CUDA
    events around every launch, ``(capacity, k_act, start, end)`` in
    ``log``; with ``keep_cap``, a copy of the first launch's inputs at that
    capacity in ``kept`` (for the twin)."""
    log, kept, launch = [], {}, F.fused_chunk

    def timed(packed, sched, seed, k_act, plan, out=None, emit_starts=None):
        cap = packed.shape[1]
        if cap == keep_cap and not kept:
            kept["args"] = (packed.clone(), sched.clone(), seed, k_act, plan)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        res = launch(packed, sched, seed, k_act, plan, out=out,
                     emit_starts=emit_starts)
        ev1.record()
        log.append((cap, k_act, ev0, ev1))
        return res

    def restore():
        F.fused_chunk = launch

    F.fused_chunk = timed
    return log, kept, restore


def collect_hook(step, at_call, edit):
    """Run ``edit(sim)`` from ``step.collect`` at its ``at_call``-th call
    (an instance attribute: the prover still sees the step's type)."""
    base, calls = step.collect, []

    def collect(sim, records):
        base(sim, records)
        calls.append(len(sim.ts))
        if len(calls) == at_call:
            edit(sim)

    step.collect = collect
    return calls


def main_plan_sim(phys, n, dev, iters, chunk, seed=0, scatter=True,
                  dirs=None, **kw):
    """bench.py's steps (without the scatter with ``scatter=False``): n
    photons from the origin along +x, or along ``dirs`` (3, n); none with
    n = 0 (a run to restore)."""
    light = phys.light
    sim = phys.Simulation(until_t=(iters - 0.5) * 1e-3, seed=seed,
                          chunk_steps=chunk, device=dev, auto_shrink=False,
                          **kw)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    if scatter:
        sim.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                   n=np.double(0.001)))
    meas = light.ScatterSignMeasureStep(None, True)
    sim.add_step(3, meas)
    kw = {} if dirs is None else {"v": dirs * float(light.c)}
    if n:
        sim.add_photons(light.generate_photon_state(n, E=1.0, device=dev,
                                                    **kw))
    return sim, meas


def injection_path(torch, phys, F, dev, card, compare):
    """Phase: bench.py's 10**7 photons with 2**20 more injected from the
    measure step's collect after chunk 2; returns the run's kernels-line
    entry (the first chunk at the grown capacity) and the finished sim."""
    from physicl_tpu_torch.population import PopulationManager
    from physicl_tpu_torch.state import pad_capacity

    phase(f"mid-run injection on the main path: {INJ_N} photons, "
          f"{INJ_ADD} injected after chunk 2, chunks of {INJ_CHUNK}")
    light = phys.light
    cap0, cap1 = pad_capacity(INJ_N), pad_capacity(INJ_N + INJ_ADD)
    sim, meas = main_plan_sim(phys, INJ_N, dev, INJ_CHUNKS * INJ_CHUNK,
                              INJ_CHUNK)
    collect_hook(meas, 2, lambda s: s.add_photons(
        light.generate_photon_state(INJ_ADD, E=2.0, device=dev)))
    inj = {}
    real = PopulationManager._apply_injections

    def watched(self, state, plan):
        if not self.sim._pending_inject:
            return real(self, state, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, state, plan)
        torch.cuda.synchronize()
        inj["ms"] = (time.perf_counter() - t0) * 1e3
        inj["at"] = len(self.sim.ts)
        return out

    F.fused_transport.launches = F.fused_transport.seq_launches = 0
    log, kept, restore = timed_launches(F, torch, keep_cap=cap1)
    PopulationManager._apply_injections = watched
    try:
        wall, _, peak = run_sim(torch, sim)
    finally:
        PopulationManager._apply_injections = real
        restore()
    launches = F.fused_transport.launches
    check(sim.used_fused, "the injected main path left the fused tier")
    check(F.fused_transport.seq_launches == launches == len(log),
          f"{F.fused_transport.seq_launches} of {launches} launches ran "
          "variant 64")
    log = [e for e in log if e[1] > 0]  # a t-exit's last launch is empty
    check(len(log) == INJ_CHUNKS, f"{len(log)} full chunks")
    st = sim.sim_state
    n = np.asarray(meas.data)[:, 1]
    E = st.E[st.alive]
    n_new = int((E == 2.0).sum())
    check(st.capacity == cap1 and int(st.n_spawned) == INJ_N + INJ_ADD
          and n_new == INJ_ADD and int(st.alive.sum()) == INJ_N + INJ_ADD,
          f"injection: capacity {st.capacity}, spawn mark "
          f"{int(st.n_spawned)}, {n_new} injected photons alive")
    at = int(np.argmax(n > INJ_N))
    check(at == inj.get("at") and n[0] == INJ_N and n[-1] == INJ_N + INJ_ADD
          and (n[:at] == INJ_N).all() and (n[at:] == INJ_N + INJ_ADD).all(),
          f"records: the alive count steps at iteration {at}, the "
          f"injection landed at {inj.get('at')}")
    speed = torch.linalg.vector_norm(st.v[:, st.alive].double(), dim=0)
    check(float((speed / C_LIGHT - 1).abs().max()) < 1e-6,
          "|v| drifted off c")
    # the first launch of the run is not in the mean: it pays for the
    # allocations of the first chunk at this size
    before = [a.elapsed_time(b) for c, _, a, b in log[1:] if c == cap0]
    after = [a.elapsed_time(b) for c, _, a, b in log if c == cap1]
    first_after = next(i for i, e in enumerate(log) if e[0] == cap1)
    gap = log[first_after - 1][3].elapsed_time(log[first_after][2])
    gaps = [log[i - 1][3].elapsed_time(log[i][2])
            for i in range(1, len(log)) if i != first_after]
    rate, steady_s = steady_rate(sim, n)
    print(f"injection: {INJ_ADD} photons landed at iteration {at} (queued "
          f"by the collect after chunk 2, applied where the depth-4 "
          f"pipeline next drained); capacity {cap0} -> {cap1}; "
          f"fused_transport launches {launches}, all variant 64; "
          f"kernel per chunk (the first {log[0][2].elapsed_time(log[0][3]):.3f}"
          f" ms) {np.mean(before):.3f} ms before "
          f"({[round(x, 3) for x in before]}), {np.mean(after):.3f} ms "
          f"after ({[round(x, 3) for x in after]}; capacity ratio "
          f"{cap1 / cap0:.4f}, time ratio "
          f"{np.mean(after) / np.mean(before):.4f}) [{card}]", flush=True)
    print(f"injection boundary: {inj['ms']:.3f} ms of host and device time "
          f"in _apply_injections (synchronized), device idle "
          f"{gap:.3f} ms between the kernels around it (other boundaries "
          f"{min(gaps):.3f}-{max(gaps):.3f} ms); "
          f"{rate:.4e} photon-steps/s over the dispatch loop after the "
          f"first chunk ({steady_s * 1e3:.1f} ms of device time); wall "
          f"{wall:.2f} s, peak memory {peak / 2 ** 30:.2f} GiB [{card}]",
          flush=True)
    packed, sched, seed, k, plan = kept["args"]
    check(plan.kernel_variant == 64, f"variant {plan.kernel_variant} at "
          "the grown capacity")
    entry = {"plain_ms": compare("injected-chunk", packed, sched,
                                 min(k, TWIN_ITERS), plan, None,
                                 "main-injected", seed, need_bitwise=True),
             "plain_iters": min(k, TWIN_ITERS)}
    out = torch.empty_like(packed)
    entry["ms"] = cuda_ms(lambda: F.fused_transport(packed, out, sched, seed,
                                                    k, plan), 3, torch)
    entry["bound_ms"], entry["bound_by"] = transport_bound(plan, cap1, k,
                                                           None)
    print(f"injected-chunk: the first chunk at {cap1} slots ({k} "
          f"iterations) equals the twin over {entry['plain_iters']}; "
          f"kernel {entry['ms']:.2f} ms, twin {entry['plain_ms']:.1f} ms, "
          f"bound {entry['bound_ms']:.2f} ms ({entry['bound_by']}) "
          f"[{card}]", flush=True)
    del packed, sched, out, kept
    return {**entry, "launches": launches}, sim


def midrun_card_vs_cpu(torch, phys, F, dev):
    """Phase: the injection, a removal, a fallback to the generic tier and
    a restored run, each on the card and on the CPU twin at 2**16:
    ``sim.ts``, records and final planes bitwise equal."""
    import tempfile

    phase(f"mid-run edits and a restore on the card against the CPU "
          f"({TWIN_N} photons, {TWIN_ITERS_RUN} iterations in chunks of "
          f"{TWIN_CHUNK})")
    light = phys.light
    dirs = np.random.default_rng(41).normal(size=(3, TWIN_N))
    dirs /= np.linalg.norm(dirs, axis=0)
    tmp = tempfile.mkdtemp()
    ck = os.path.join(tmp, "restore.npz")
    first, _ = main_plan_sim(phys, TWIN_N, dev, TWIN_ITERS_RUN // 2,
                             TWIN_CHUNK, seed=8)
    run_sim(torch, first)
    first.save_checkpoint(ck)
    del first

    def build(case, where):
        if case == "restore":
            sim = phys.Simulation(until_t=(TWIN_ITERS_RUN - 0.5) * 1e-3,
                                  seed=8, chunk_steps=TWIN_CHUNK,
                                  device=where, auto_shrink=False)
            sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
            sim.add_step(1, phys.newton.NewtonianKinematicsStep())
            sim.add_step(2, light.ScatterIsotropicStep(A=np.double(0.001),
                                                       n=np.double(0.001)))
            meas = light.ScatterSignMeasureStep(None, True)
            sim.add_step(3, meas)
            sim.restore_checkpoint(ck)
            return sim, meas
        sim, meas = main_plan_sim(
            phys, TWIN_N, where, TWIN_ITERS_RUN, TWIN_CHUNK, seed=6,
            scatter=case != "fallback", dirs=dirs)
        if case == "inject":
            k = TWIN_N // 16
            collect_hook(meas, 2, lambda s: s.add_photons(
                light.generate_photon_state(k, E=2.0, device=where,
                                            v=dirs[:, :k] * float(light.c))))
        elif case == "remove":
            objs = [light.PhotonObject(
                E=np.double(5.0 + i),
                v=np.array([float(light.c), 0.0, 0.0])) for i in range(16)]
            for o in objs:
                sim.add_obj(o)
            collect_hook(meas, 2, lambda s: s.remove_obj(objs[3]))
        else:
            collect_hook(meas, 2, lambda s: s.add_obj(phys.Object(
                v=phys.Measurement([5.0, 0, 0], "m**1 s**-1"))))
        return sim, meas

    for case, fused in (("inject", True), ("remove", True),
                        ("fallback", False), ("restore", True)):
        runs = {}
        for where in (dev, "cpu"):
            sim, meas = build(case, where)
            if case == "fallback":
                import warnings
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # the fallback's
                    sim.start()
                    sim.join()
            else:
                sim.start()
                sim.join()
            runs[str(where) if where == "cpu" else "card"] = (
                sim, np.asarray(meas.data), F.pack_state(sim.sim_state).cpu())
        (gs, gd, gst), (cs, cd, cst) = runs["card"], runs["cpu"]
        check(gs.used_fused == cs.used_fused == fused,
              f"{case}: used_fused card {gs.used_fused}, CPU {cs.used_fused}")
        check(len(gs.ts) == TWIN_ITERS_RUN and gs.ts == cs.ts,
              f"{case}: sim.ts differs between card and CPU")
        check(np.array_equal(gd, cd), f"{case}: records differ")
        check(gst.shape == cst.shape and torch.equal(gst, cst),
              f"{case}: final planes not bitwise equal (max abs err "
              f"{float((gst - cst).abs().max()) if gst.shape == cst.shape else 'shape'})")
        n = gd[:, 1]
        print(f"{case} card == CPU: sim.ts, {len(gd)} record rows and the "
              f"final planes ({gst.shape[1]} slots) bitwise; fused "
              f"{gs.used_fused}; alive {int(n[0])} -> {int(n[-1])}",
              flush=True)
    os.remove(ck)
    os.rmdir(tmp)


def sort_media_sim(phys, grid, dev, sort, seed=31):
    """The media path's plan with n photons at uniform positions over the
    phantom and isotropic directions (the locality-free case), SORT_ITERS
    iterations in chunks of SORT_CHUNK, ``spatial_sort=sort``."""
    import torch

    light = phys.light
    n = SORT_N
    c = float(light.c)
    c_dt = c * MEDIA_DT
    sp = 4 * c_dt
    nv = grid.shape[0]
    nfn = light.voxel_density(grid, spacing=sp, interp="trilinear")
    sim = phys.Simulation(until_t=(SORT_ITERS - 0.5) * MEDIA_DT, seed=seed,
                          chunk_steps=SORT_CHUNK, device=dev,
                          auto_shrink=False, spatial_sort=sort)
    sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(MEDIA_DT)))
    sim.add_step(1, phys.newton.NewtonianKinematicsStep())
    sim.add_step(2, light.ScatterIsotropicStep(
        A=MEDIA_AS / c_dt, variable_n=True, variable_n_fn=nfn))
    sim.add_step(3, light.ScatterDeleteStep(
        1.0, MEDIA_AA / c_dt, variable_n=True, variable_n_fn=nfn,
        implicit_capture=True, roulette=MEDIA_ROULETTE,
        measure_deposition=True))
    sim.add_step(4, phys.newton.AbsorbingBoundaryStep(((-sp, nv * sp),) * 3))
    meas = light.ScatterMeasureStep(
        None, True, [((nv - 1) * sp, np.nan, np.nan)], weighted=True,
        measure_E=True, measure_E_mode="sum")
    sim.add_step(5, meas)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = torch.rand((3, n), generator=gen, device=dev) * ((nv - 1) * sp)
    sim.add_photons(light.generate_photon_state(
        n, E=1.0, r=r, v=isotropic_v(torch, n, c, gen, dev), device=dev))
    return sim, meas


def sorted_media_path(torch, phys, F, grid, dev, card):
    """Phase: the locality-free media case with ``spatial_sort=1`` and
    with it off: the kernel's time per chunk, the sort's time, the rates;
    the alive counts agree within 5 sigma."""
    phase(f"spatial_sort on the media path: {SORT_N} photons uniform in the "
          f"{MEDIA_NV}**3 phantom, isotropic, {SORT_ITERS} iterations in "
          f"chunks of {SORT_CHUNK}")
    sorts = []

    def timed_sort(fn):
        """The sort as the fused loop calls it: the keys, the argsort and
        the gather of the provider's packed planes (no repack follows)."""
        def sort(state, pop, provider=None):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(state, pop, provider)
            b.record()
            if out is not state:
                sorts.append((a, b))
            return out

        return sort

    res = {}
    for sort in (0, 1, 1, 0):
        sim, meas = sort_media_sim(phys, grid, dev, sort)
        sim._maybe_spatial_sort = timed_sort(sim._maybe_spatial_sort)
        F.fused_transport.launches = 0
        log, _, restore = timed_launches(F, torch)
        try:
            wall, _, peak = run_sim(torch, sim)
        finally:
            restore()
        full = [e for e in log if e[1] > 0]  # the t-exit's last is empty
        check(sim.used_fused and F.fused_transport.launches == len(log)
              and len(full) == SORT_ITERS // SORT_CHUNK,
              f"sort={sort}: fused {sim.used_fused}, {len(full)} of "
              f"{len(log)} launches full")
        check((sim._sort_fn is not None) == bool(sort),
              f"sort={sort}: the sort was {'not ' if sort else ''}set up")
        data = np.asarray(meas.data)
        rate, _ = steady_rate(sim, data[:, 1])
        res.setdefault(sort, []).append({
            "ms": [a.elapsed_time(b) for _, _, a, b in full],
            "n": int(data[-1, 1]), "rate": rate, "wall": wall,
            "peak": peak})
        del sim
    n_sorts = len(sorts)
    # one sort before every chunk; none before the t-exit's empty dispatch
    check(n_sorts == 2 * (SORT_ITERS // SORT_CHUNK),
          f"{n_sorts} sorts in the two sorted runs")
    sort_ms = [a.elapsed_time(b) for a, b in sorts]
    for sort in (0, 1):
        for r in res[sort]:
            print(f"spatial_sort={sort}: kernel per chunk "
                  f"{[round(x, 2) for x in r['ms']]} ms (mean "
                  f"{np.mean(r['ms']):.2f}), {r['rate']:.4e} alive "
                  f"photon-steps/s over the dispatch loop after the first "
                  f"chunk, wall {r['wall']:.2f} s, alive at the end "
                  f"{r['n']}, peak memory {r['peak'] / 2 ** 30:.2f} GiB "
                  f"[{card}]", flush=True)
    print(f"the sort: median {np.median(sort_ms):.3f} ms a call (the keys, "
          f"a stable argsort and one gather of the packed planes, which is "
          f"all it costs the next dispatch; the first call "
          f"of the process pays the argsort's set-up; {n_sorts} calls: "
          f"{[round(x, 3) for x in sort_ms]}) [{card}]", flush=True)
    n0, n1 = res[0][0]["n"], res[1][0]["n"]
    p = n0 / SORT_N
    sigma = np.sqrt(2 * SORT_N * p * (1 - p)) + 1
    check(abs(n1 - n0) <= 5 * sigma, f"alive counts {n0} unsorted, {n1} "
          f"sorted: {abs(n1 - n0) / sigma:.2f} sigma")
    check(res[0][0]["n"] == res[0][1]["n"] and res[1][0]["n"]
          == res[1][1]["n"], "a second run with the same seed gave other "
          "alive counts")
    print(f"alive counts sorted {n1}, unsorted {n0}: "
          f"{abs(n1 - n0) / sigma:.2f} combined sigma", flush=True)
    return {0: res[0], 1: res[1], "sort_ms": sort_ms}


def checkpoint_path(torch, phys, F, sim, dev, card):
    """Phase: save the injected run's state (11,059,200 slots) and restore
    it onto the fused tier: seconds, bytes, planes equal after the
    restore."""
    import tempfile

    phase(f"checkpoint: save and restore at {sim.sim_state.capacity} slots")
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "ck.npz")
    t0 = time.perf_counter()
    sim.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    saved = F.pack_state(sim.sim_state)
    n0 = int(sim.sim_state.alive.sum())
    new, meas = main_plan_sim(phys, 0, dev, len(sim.ts) + INJ_CHUNK,
                              INJ_CHUNK)
    t0 = time.perf_counter()
    new.restore_checkpoint(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(torch.equal(F.pack_state(new._restored[0]), saved),
          "the restored planes differ from the saved ones")
    del saved
    F.fused_transport.launches = 0
    wall, _, _ = run_sim(torch, new)
    check(new.used_fused and F.fused_transport.launches >= 1
          and len(new.ts) == len(sim.ts) + INJ_CHUNK and new.ts[:len(sim.ts)]
          == sim.ts and np.asarray(meas.data)[0, 1] == n0,
          f"restored run: fused {new.used_fused}, "
          f"{F.fused_transport.launches} launches, {len(new.ts)} iterations")
    os.remove(path)
    os.rmdir(tmp)
    print(f"checkpoint: {size} bytes ({size / 2 ** 20:.1f} MiB, "
          f"np.savez_compressed) saved in {save_s:.2f} s, restored to the "
          f"card in {load_s:.2f} s; the restored run took the fused tier "
          f"for one chunk of {INJ_CHUNK} ({wall:.2f} s wall, {n0} alive) "
          f"[{card}]", flush=True)
    return {"save_s": save_s, "load_s": load_s, "bytes": size}


def bridge_and_profiling(torch, phys, F, dev, card):
    """Phase: KernelProgram.run on the card against the CPU (no draws:
    equal outputs and tracked indices), then a profiling.trace of a fused
    run that names the transport kernel, and ChunkTimerStep rows."""
    import json as _json
    import tempfile

    from physicl_tpu_torch import kernels as K
    from physicl_tpu_torch.utils import profiling

    phase(f"KernelProgram on the card against the CPU ({BRIDGE_N} photons)")
    rng = np.random.default_rng(5)
    d = rng.normal(size=(3, BRIDGE_N))
    bulk = phys.light.generate_photon_state(
        BRIDGE_N, E=rng.uniform(0.5, 2.0, BRIDGE_N),
        v=d / np.linalg.norm(d, axis=0) * C_LIGHT,
        r=rng.uniform(-1e6, 1e6, (3, BRIDGE_N)))

    def body(valid, r0, v1, E, A):
        score = abs(r0) * A + v1 * v1 * 1e-12 + E
        return {"score": score * valid, "hit": (score > A * 5e5) & valid}

    outs = {}
    for where in (dev, "cpu"):
        st = phys.SimState.from_population([], [bulk], device=where)
        prog = K.KernelProgram(None, "score", body)
        prog.prep_metadata = [
            K.KernelInput(name="photons", type="obj_action",
                          code="type(obj) == PhotonObject"),
            K.KernelInput(name="r0", type="obj", obj_attr="r[0]"),
            K.KernelInput(name="v1", type="obj", obj_attr="v[1]"),
            K.KernelInput(name="E", type="obj", obj_attr="E"),
            K.KernelInput(name="A", type="const", const_value=0.5),
            K.KernelInput(name="sel", type="obj_track")]
        prog.output_metadata = [K.KernelOutput(name="score"),
                                K.KernelOutput(name="hit", ctype="int")]
        prog.build_kernel()
        prog.run(st)
        t0 = time.perf_counter()
        out = prog.run(st)
        outs["cpu" if where == "cpu" else "card"] = (
            out, prog.sel, time.perf_counter() - t0)
    (go, gsel, gt), (co, csel, ct) = outs["card"], outs["cpu"]
    check(all(np.array_equal(go[k], co[k]) for k in co)
          and np.array_equal(gsel, csel) and 0 < go["hit"].sum() < BRIDGE_N,
          "KernelProgram: the card's outputs differ from the CPU's")
    print(f"KernelProgram: outputs and tracked indices equal on the card "
          f"and the CPU ({int(go['hit'].sum())} hits); run() {gt * 1e3:.2f}"
          f" ms on the card, {ct * 1e3:.2f} ms on the CPU, host arrays "
          f"included [{card}]", flush=True)

    phase("profiling: a trace of a fused run and ChunkTimerStep rows")
    tmp = tempfile.mkdtemp()
    sim, _ = main_plan_sim(phys, BRIDGE_N, dev, 512, 256)
    with profiling.trace(tmp) as prof:
        sim.start()
        sim.join()
        torch.cuda.synchronize()
    files = os.listdir(tmp)
    check(len(files) == 1, f"trace files {files}")
    with open(os.path.join(tmp, files[0])) as f:
        names = {e.get("name", "") for e in _json.load(f)["traceEvents"]}
    kern = sorted(n for n in names if "fused_seq_kernel" in n)
    check(sim.used_fused and kern, "the trace names no transport kernel")
    dev_ms = sum(e.device_time_total for e in prof.key_averages()
                 if "fused_seq_kernel" in e.key) / 1e3
    os.remove(os.path.join(tmp, files[0]))
    os.rmdir(tmp)
    timer = profiling.ChunkTimerStep()
    sim, _ = main_plan_sim(phys, BRIDGE_N, dev, 96, 32)
    sim.add_step(9, timer)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # [unsupported-step]: generic tier
        run_sim(torch, sim)
    check(not sim.used_fused and [r[0] for r in timer.data] == [32] * 3,
          f"ChunkTimerStep rows {timer.data}")
    print(f"profiling.trace: {files[0]} names {kern[0][:60]}..., "
          f"{dev_ms:.2f} ms of device time in it; ChunkTimerStep on the "
          f"generic tier (unsupported-step, as in the JAX package): "
          + ", ".join(f"({i}, {w * 1e3:.2f} ms, {r:.4e} photon-steps/s)"
                      for i, w, r in timer.data) + f" [{card}]", flush=True)


# -- one-process mesh and differentiable runs ----------------------------------

MESH_SHARDS = 8          # the JAX tests' 8 virtual devices, on one card
MESH_N = 10_000_000      # bench.py's width
MESH_CHUNK = 1024
MESH_CHUNKS = 5
MESH_TWIN_N = 1 << 16    # the card-against-CPU mesh runs
MESH_TWIN_CHUNK = 64
FN_N = 1 << 20           # the transmission gradient
FN_N_BIG = 10_000_000
FN_ITERS = 100
FN_P = 0.01              # absorption per iteration under implicit capture
FN_CPU_N = 1 << 16


def sim_planes(sim, torch):
    """The run's final global planes on the host."""
    st = sim.sim_state
    return {k: getattr(st, k).cpu() for k in ("r", "v", "E", "w", "alive",
                                                "otype")}


def mesh_card_vs_cpu(torch, phys, dev, devices=None):
    """The 8-shard main plan, emitter windows across shard edges, recycling
    with absorption, a mid-run injection that grows the arena and a
    checkpoint resharded 8 -> 4, each on the card and on the CPU twin:
    ``sim.ts``, records and final planes bitwise equal. The card side's
    shards cycle over ``devices`` (default: ``dev`` alone)."""
    import tempfile
    from physicl_tpu_torch.parallel import make_mesh

    light = phys.light
    unit = MESH_SHARDS * 16384
    dirs = np.random.default_rng(43).normal(size=(3, MESH_TWIN_N))
    dirs /= np.linalg.norm(dirs, axis=0)
    tmp = tempfile.mkdtemp()
    cards = [dev] if devices is None else list(devices)

    def mesh(where, n=MESH_SHARDS):
        return make_mesh(n, devices=["cpu"] if where == "cpu" else cards)

    def emitter(where, n_emit, n0, iters, chunk, absorb=False):
        sim = phys.Simulation(until_t=(iters - 0.5) * 1e-3, seed=11,
                              chunk_steps=chunk, device=where,
                              capacity=unit, mesh=mesh(where))
        sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
        sim.add_step(1, light.PhotonEmitterStep(n_emit, E=2.0))
        sim.add_step(2, phys.newton.NewtonianKinematicsStep())
        if absorb:
            sim.add_step(3, light.ScatterDeleteStep(np.double(0.001),
                                                    np.double(0.001)))
        meas = light.ScatterSignMeasureStep(None, True)
        sim.add_step(4, meas)
        sim.add_photons(light.generate_photon_state(n0, E=1.0))
        return sim, meas

    def layered(where, t_end, n_shards, restore=None):
        c_dt = float(light.c) * 1e-3
        nfn = light.layered_density(np.array([0.5, 3.5, 6.5]) * c_dt,
                                    [1.0, 2.0])
        sim = phys.Simulation(until_t=t_end * 0.9999, seed=0, device=where,
                              mesh=mesh(where, n_shards))
        sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
        sim.add_step(1, phys.newton.NewtonianKinematicsStep())
        sim.add_step(2, light.ScatterDeleteStep(
            np.double(1.0), np.double(0.2 / c_dt), variable_n=True,
            variable_n_fn=nfn, implicit_capture=True))
        meas = light.ScatterSignMeasureStep(None, True)
        sim.add_step(3, meas)
        if restore is None:
            sim.add_photons(light.generate_photon_state(
                MESH_TWIN_N, E=1.0, v=dirs * float(light.c)))
        else:
            sim.restore_checkpoint(restore)
        return sim, meas

    def build(case, where):
        if case == "main":
            return main_plan_sim(phys, MESH_TWIN_N, where,
                                 2 * MESH_TWIN_CHUNK, MESH_TWIN_CHUNK,
                                 seed=5, dirs=dirs, mesh=mesh(where))
        if case == "emitter-windows":
            return emitter(where, 3000, 10000, 20, 1024)
        if case == "recycle":
            return emitter(where, 8000, 1000, 40, 8, absorb=True)
        if case == "inject":
            sim, meas = main_plan_sim(
                phys, unit - 200, where, 16, 4, seed=6,
                fused_pipeline_depth=1, mesh=mesh(where))
            collect_hook(meas, 1, lambda s: s.add_photons(
                light.generate_photon_state(
                    MESH_TWIN_N, E=2.0, v=dirs * float(light.c))))
            return sim, meas
        # reshard: the card's 8-shard checkpoint resumed on 4 shards
        return layered(where, 0.008, 4, restore=ck)

    first, _ = layered(dev, 0.004, MESH_SHARDS)
    run_sim(torch, first)
    ck = os.path.join(tmp, "mesh8.npz")
    first.save_checkpoint(ck)
    ref, _ = layered(dev, 0.008, MESH_SHARDS)
    run_sim(torch, ref)
    w_ref = ref.sim_state.w.cpu()
    del first
    results = []
    for case in ("main", "emitter-windows", "recycle", "inject", "reshard"):
        runs = {}
        for where in (dev, "cpu"):
            sim, meas = build(case, where)
            run_sim(torch, sim)
            check(sim.used_fused, f"mesh {case} on {where}: not fused")
            runs[where] = (sim, np.asarray(meas.data))
        (cs, cd), (hs, hd) = runs[dev], runs["cpu"]
        check(np.asarray(cs.ts, np.float32).tobytes()
              == np.asarray(hs.ts, np.float32).tobytes(),
              f"mesh {case}: sim.ts differs card against CPU")
        check(np.array_equal(cd, hd), f"mesh {case}: records differ card "
              f"against CPU (first rows {cd[:2].tolist()} / "
              f"{hd[:2].tolist()})")
        a, b = sim_planes(cs, torch), sim_planes(hs, torch)
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        check(not bad, f"mesh {case}: planes {bad} differ card against CPU")
        extra = ""
        if case == "recycle":
            n_rec = [e[0] for e in cs.population_log].count("recycle")
            check(n_rec >= 1 and cs.population_log == hs.population_log,
                  f"mesh recycle: {cs.population_log}")
            extra = f", {n_rec} recycles"
        if case == "inject":
            check(cs.sim_state.capacity == 2 * unit
                  and int(cd[-1, 1]) == unit - 200 + MESH_TWIN_N,
                  f"mesh inject: capacity {cs.sim_state.capacity}")
            extra = f", capacity {unit} -> {cs.sim_state.capacity}"
        if case == "reshard":
            check(torch.equal(a["w"], w_ref), "mesh reshard: the 4-shard "
                  "resume differs from the uninterrupted 8-shard run")
            extra = ", equal to the uninterrupted 8-shard run"
        results.append(f"{case} ({len(cs.ts)} iterations, capacity "
                       f"{cs.sim_state.capacity}{extra})")
        del runs, cs, hs
    os.remove(ck)
    os.rmdir(tmp)
    print(f"mesh card against CPU twin, shards on {[str(d) for d in cards]}"
          ", bitwise (sim.ts, records, planes): " + "; ".join(results),
          flush=True)


def mesh_path(torch, phys, F, dev, card, compare, devices=None):
    """Phase: bench.py's 10**7 photons over an 8-shard mesh on one card,
    every launch variant 64, the chunk time of the 8 launches against the
    unsharded chunk of the same plan (CUDA events around each launch);
    then the mesh runs on the card against the CPU twin, and with several
    ``devices`` (default: every card) :func:`mesh_cards`. Returns the
    kernels-line entry."""
    from physicl_tpu_torch.parallel import make_mesh
    from physicl_tpu_torch.state import pad_capacity

    phase(f"mesh: {MESH_N} photons over {MESH_SHARDS} shards on one card, "
          f"{MESH_CHUNKS} chunks of {MESH_CHUNK}")
    iters = MESH_CHUNKS * MESH_CHUNK
    unit = pad_capacity(1) * MESH_SHARDS
    cap = -(-MESH_N // unit) * unit
    local = cap // MESH_SHARDS

    def chunk_ms(log, per_chunk):
        """Per chunk (its launches together), the chunks after the first."""
        log = [e for e in log if e[1] > 0]  # a t-exit's launch is empty
        out = [log[i][2].elapsed_time(log[i + per_chunk - 1][3])
               for i in range(0, len(log), per_chunk)]
        return out[1:]

    sim, _ = main_plan_sim(phys, MESH_N, dev, iters, MESH_CHUNK)
    log, _, restore = timed_launches(F, torch)
    try:
        run_sim(torch, sim)
    finally:
        restore()
    plain_chunks = chunk_ms(log, 1)
    del sim

    sim, meas = main_plan_sim(phys, MESH_N, dev, iters, MESH_CHUNK,
                              mesh=make_mesh(MESH_SHARDS, devices=[dev]))
    F.fused_transport.launches = F.fused_transport.seq_launches = 0
    log, kept, restore = timed_launches(F, torch, keep_cap=local)
    try:
        wall, _, peak = run_sim(torch, sim)
    finally:
        restore()
    launches = F.fused_transport.launches
    check(sim.used_fused, "the mesh main path left the fused tier")
    check(F.fused_transport.seq_launches == launches == len(log)
          and launches >= MESH_SHARDS * MESH_CHUNKS
          and launches % MESH_SHARDS == 0,
          f"{F.fused_transport.seq_launches} of {launches} mesh launches "
          "ran variant 64")
    check(all(e[0] == local for e in log), "a launch not over one shard")
    mesh_chunks = chunk_ms(log, MESH_SHARDS)
    data = np.asarray(meas.data)
    n_iter = len(sim.ts)
    check(n_iter == iters and bool((data[:, 1] == MESH_N).all()),
          f"mesh: {n_iter} iterations, counts {data[:2, 1]}")
    pcoll = 0.001 * 0.001 * C_LIGHT * 0.001
    shares = data[:, 2] / data[:, 1]
    expect = 0.5 + 0.5 * (1 - pcoll) ** np.arange(1, n_iter + 1)
    parity = float(np.abs(shares - expect).max())
    check(parity < 0.02, f"mesh scatter parity {parity}")
    st = sim.sim_state
    check(st.capacity == cap and bool(torch.isfinite(st.r).all()),
          f"mesh capacity {st.capacity}")
    ratio = np.mean(mesh_chunks) / np.mean(plain_chunks)
    print(f"mesh: {launches} launches over {len(sim.chunk_log)} chunks, "
          f"all variant 64 on {local}-slot shards (capacity {cap}); parity "
          f"err {parity:.2e}; chunk of {MESH_CHUNK} iterations: "
          f"{np.mean(mesh_chunks):.3f} ms for the 8 launches together "
          f"({[round(x, 3) for x in mesh_chunks]}) against "
          f"{np.mean(plain_chunks):.3f} ms unsharded "
          f"({[round(x, 3) for x in plain_chunks]}), ratio {ratio:.4f}; "
          f"wall {wall:.2f} s, set-up {sim.setup_seconds:.3f} s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
    del sim, st
    packed, sched, seed, k, plan = kept["args"]
    entry = {"plain_ms": compare("mesh-shard0", packed, sched,
                                 min(k, TWIN_ITERS), plan, None, "main-mesh",
                                 seed, need_bitwise=True),
             "plain_iters": min(k, TWIN_ITERS), "plain_slots": local,
             "ms": float(np.mean(mesh_chunks)),
             "unsharded_ms": float(np.mean(plain_chunks))}
    entry["bound_ms"], entry["bound_by"] = transport_bound(plan, cap, k,
                                                           None)
    print(f"mesh-shard0: shard 0's first chunk ({local} slots) equals the "
          f"twin over {entry['plain_iters']} iterations; twin "
          f"{entry['plain_ms']:.1f} ms; bound of the whole chunk "
          f"{entry['bound_ms']:.2f} ms ({entry['bound_by']}) [{card}]",
          flush=True)
    del packed, sched, kept
    mesh_card_vs_cpu(torch, phys, dev)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if len(devices) > 1:
        mesh_cards(torch, phys, devices, card)
    return {**entry, "launches": launches}, data, plan


def mesh_cards(torch, phys, cards, card):
    """Phase, on a host with several cards: the mesh runs of
    :func:`mesh_card_vs_cpu` with the card side's shards spread over
    ``cards``, bitwise against the CPU twin; then bench.py's main path
    (MESH_N photons, MESH_CHUNKS chunks of MESH_CHUNK) unsharded, over
    8 shards on the first card, over 8 shards on every card and over one
    shard a card: the time of each chunk after the first on the first
    card's clock, between the events the engine records after each chunk's
    records (which wait for every card's launches)."""
    from physicl_tpu_torch.parallel import make_mesh

    phase(f"mesh over {len(cards)} cards")
    mesh_card_vs_cpu(torch, phys, cards[0], devices=cards)
    iters = MESH_CHUNKS * MESH_CHUNK
    meshes = (("unsharded", None),
              (f"{MESH_SHARDS} shards on one card",
               make_mesh(MESH_SHARDS, devices=cards[:1])),
              (f"{MESH_SHARDS} shards on {len(cards)} cards",
               make_mesh(MESH_SHARDS, devices=cards)),
              (f"one shard on each of {len(cards)} cards",
               make_mesh(devices=cards)))
    for name, mesh in meshes:
        sim, meas = main_plan_sim(phys, MESH_N, cards[0], iters, MESH_CHUNK,
                                  mesh=mesh)
        run_sim(torch, sim)
        for d in cards:
            torch.cuda.synchronize(d)
        data = np.asarray(meas.data)
        check(sim.used_fused and len(sim.ts) == iters
              and bool((data[:, 1] == MESH_N).all()),
              f"mesh over cards, {name}: {len(sim.ts)} iterations")
        log = [(n, e) for _, n, e in sim.chunk_log]
        per = [log[i - 1][1].elapsed_time(log[i][1])
               for i in range(1, len(log)) if log[i][0] > 0]
        print(f"mesh over cards, {name}: chunk of {MESH_CHUNK} iterations "
              f"at {MESH_N} photons {np.mean(per):.3f} ms on the first "
              f"card's clock between chunk events "
              f"({[round(x, 3) for x in per]}) [{card}]", flush=True)
        del sim, meas


def functional_path(torch, phys, dev, card):
    """Phase: differentiable runs on the card. The transmission T = (1 -
    p)**K of implicit capture and dT/dA = -K c dt (1 - p)**(K - 1) at 2**20
    photons against the closed form; a checkpointed (remat) gradient with
    roulette draws equal to the plain one bitwise (the card's generator
    replayed); the gradient at 2**16 equal to the CPU's within 1e-5; then
    10**7 photons, plain and remat: forward and backward times and peak
    memory."""
    from physicl_tpu_torch import functional as Fn
    from physicl_tpu_torch.state import SimState

    phase(f"differentiable runs: scan_steps at {FN_N} and {FN_N_BIG} "
          f"photons, {FN_ITERS} iterations")
    light = phys.light
    c_dt = C_LIGHT * 1e-3
    A0 = FN_P / c_dt

    def run(n, where, remat=False, roulette=None, key=0):
        st = SimState.from_population(
            [], [light.generate_photon_state(n, E=1.0, device=where)],
            device=where)
        if where != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        A = torch.tensor(A0, dtype=torch.float32, device=where,
                         requires_grad=True)
        steps = [phys.UpdateTimeStep(lambda s: 1e-3),
                 phys.newton.NewtonianKinematicsStep(),
                 light.ScatterDeleteStep(n=1.0, A=A, implicit_capture=True,
                                         roulette=roulette)]
        t0 = time.perf_counter()
        out = Fn.scan_steps(steps, st, FN_ITERS, key=key, remat=remat)
        T = (out.w * out.alive).sum() / n
        if where != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        (g,) = torch.autograd.grad(T, A)
        if where != "cpu":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if where != "cpu" else 0
        n_alive = int(out.alive.sum())
        del out, st
        return float(T.detach()), float(g), t1 - t0, t2 - t1, peak, n_alive

    T_exp = (1 - FN_P) ** FN_ITERS
    g_exp = -FN_ITERS * c_dt * (1 - FN_P) ** (FN_ITERS - 1)
    T, g, fwd, bwd, peak, _ = run(FN_N, dev)
    check(abs(T - T_exp) <= 1e-4 * T_exp and abs(g - g_exp) <= 1e-4
          * abs(g_exp), f"transmission {T} (closed form {T_exp}), dT/dA "
          f"{g} (closed form {g_exp})")
    print(f"functional: {FN_N} photons x {FN_ITERS}: T {T:.7f} (closed "
          f"form {T_exp:.7f}), dT/dA {g:.6e} (closed form {g_exp:.6e}); "
          f"forward {fwd * 1e3:.1f} ms, backward {bwd * 1e3:.1f} ms, peak "
          f"{peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
    rl = [run(FN_N, dev, remat=r, roulette=(0.5, 1.0), key=7)
          for r in (False, True)]
    check(rl[0][1] == rl[1][1] and rl[0][5] == rl[1][5] < FN_N,
          f"remat with roulette: gradients {rl[0][1]!r} / {rl[1][1]!r}, "
          f"alive {rl[0][5]} / {rl[1][5]}")
    gc, gh = run(FN_CPU_N, dev)[1], run(FN_CPU_N, "cpu")[1]
    check(abs(gc - gh) <= 1e-5 * abs(gh), f"card dT/dA {gc} against the "
          f"CPU's {gh}")
    print(f"functional: remat with roulette draws ({rl[0][5]} of {FN_N} "
          f"alive) gives the plain gradient bitwise ({rl[0][1]:.6e}); at "
          f"{FN_CPU_N} the card's dT/dA {gc:.7e} against the CPU's "
          f"{gh:.7e}", flush=True)
    big = {}
    for remat in (False, True):
        big[remat] = run(FN_N_BIG, dev, remat=remat)
        T, g, fwd, bwd, peak, _ = big[remat]
        check(abs(g - g_exp) <= 1e-4 * abs(g_exp),
              f"{FN_N_BIG} photons, remat={remat}: dT/dA {g}")
        print(f"functional: {FN_N_BIG} photons x {FN_ITERS}, remat={remat}"
              f": forward {fwd * 1e3:.1f} ms, backward {bwd * 1e3:.1f} ms, "
              f"torch.cuda.max_memory_allocated {peak / 2 ** 30:.2f} GiB, "
              f"dT/dA {g:.6e} [{card}]", flush=True)
    check(big[False][1] == big[True][1], "remat changed the gradient at "
          f"{FN_N_BIG}: {big[False][1]!r} / {big[True][1]!r}")


# -- meshes across processes ---------------------------------------------------

MP_WORLD = 2                          # processes sharing the one card
MP_SHARDS = MESH_SHARDS // MP_WORLD   # shards a process
MP_TWIN_N = 1 << 16                   # the card-against-CPU runs
MP_TRACE_N = 3 << 15                  # both processes' spans hold photons
MP_LIMIT = 300                        # seconds for the workers, all told
MP_WAIT = 120                         # seconds a collective waits
MP_GATHER_REPS = 3                    # timed gathers of each kind and size


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_workers(mode, world, out, env_of=None):
    """Run ``world`` copies of this script as ``--mp-worker`` processes of
    one process group and return each one's ``rank{r}.json`` from
    ``out``. Their output is echoed with the rank. A worker that fails, or
    workers that outlive MP_LIMIT (all are killed), fail the phase."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mp-worker", mode,
         str(r), str(world), str(port), out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **(env_of(r) if env_of else {})))
        for r in range(world)]
    outs = []
    try:
        deadline = time.monotonic() + MP_LIMIT
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                check(False, f"{mode} workers ran past {MP_LIMIT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        for line in o.splitlines():
            print(f"  [rank {r}] {line}", flush=True)
        check(p.returncode == 0, f"{mode} worker {r} exited "
              f"{p.returncode}")
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def host_timer(owner, name, sink):
    """Wrap ``owner.name`` (undo with the returned function): the host
    seconds of each call appended to ``sink``."""
    fn = getattr(owner, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            sink.append(time.perf_counter() - t0)

    setattr(owner, name, timed)
    return lambda: setattr(owner, name, fn)


def chunk_times(log, per_chunk):
    """Per chunk of ``per_chunk`` launches (the first of its launches'
    start to the last's end, this process's clock), the chunks after the
    first; a t-exit's empty launch left out."""
    log = [e for e in log if e[1] > 0]
    out = [log[i][2].elapsed_time(log[i + per_chunk - 1][3])
           for i in range(0, len(log), per_chunk)]
    return out[1:]


def mp_main_run(torch, phys, F, dev, n_shards, keep_cap=None):
    """bench.py's main path (MESH_N photons, MESH_CHUNKS chunks of
    MESH_CHUNK) on a pod mesh of ``n_shards`` shards of this process on
    ``dev``: the launch counts set to 0 just before and read just after,
    CUDA events around each launch."""
    from physicl_tpu_torch.ops import pipeline
    from physicl_tpu_torch.parallel import make_pod_mesh
    from physicl_tpu_torch.population import PopulationManager

    mesh = make_pod_mesh(devices=[dev] * n_shards)
    sim, meas = main_plan_sim(phys, MESH_N, dev, MESH_CHUNKS * MESH_CHUNK,
                              MESH_CHUNK, mesh=mesh)
    cross, guard = [], []
    undo = [host_timer(pipeline, "_combine_shards", cross),
            host_timer(PopulationManager, "check_divergence", guard)]
    F.fused_transport.launches = F.fused_transport.seq_launches = 0
    log, kept, restore = timed_launches(F, torch, keep_cap=keep_cap)
    try:
        wall, _, peak = run_sim(torch, sim)
    finally:
        restore()
        for u in undo:
            u()
    launches = F.fused_transport.launches
    seq = F.fused_transport.seq_launches
    check(sim.used_fused, "the main path across processes left the fused "
          "tier")
    ev = [e for _, n, e in sim.chunk_log]
    between = [ev[i - 1].elapsed_time(ev[i]) for i in range(1, len(ev))
               if sim.chunk_log[i][1] > 0 and ev[i] is not None]
    return {"records": np.asarray(meas.data), "launches": launches,
            "seq_launches": seq, "chunks": chunk_times(log, n_shards),
            "between": between, "wall": wall, "peak": peak,
            "setup": sim.setup_seconds, "n_iter": len(sim.ts),
            "shards": len(mesh), "capacity": sim.sim_state.capacity,
            "records_ms": [x * 1e3 for x in cross],
            "guard_ms": [x * 1e3 for x in guard]}, kept


def mp_scenarios(torch, phys, dev, rank, world, n_shards):
    """The card against the CPU twin, both across the ``world`` processes
    (pod meshes of ``n_shards`` shards a process), bitwise: an injection
    under the divergence guard, issued from a measure step's collect on
    every process; an emitter recycling on a full arena with absorption;
    the E-list of tagged energies; a shard-local trace. Returns a summary
    line and the slowest edit boundary of each case on the card."""
    from physicl_tpu_torch.parallel import make_pod_mesh

    light = phys.light
    step_len = C_LIGHT * 1e-3
    E_tag = (1.0 + np.arange(MP_TWIN_N) * 2.0 ** -16).astype(np.float32)

    def mesh(where):
        return make_pod_mesh(devices=[where] * n_shards)

    def build(case, where):
        if case == "inject":
            sim, meas = main_plan_sim(phys, MP_TWIN_N, where, 16, 4, seed=6,
                                      fused_pipeline_depth=1,
                                      mesh=mesh(where))
            collect_hook(meas, 1, lambda s: s.add_photons(
                light.generate_photon_state(MP_TWIN_N, E=2.0)))
            return sim, meas
        iters = {"recycle": 40, "elist": 6, "trace": 4}[case]
        sim = phys.Simulation(seed=11, device=where, mesh=mesh(where),
                              until_t=iters * 1e-3 * 0.9999,
                              chunk_steps=8 if case == "recycle" else None)
        sim.add_step(0, phys.UpdateTimeStep(lambda s: np.double(0.001)))
        if case == "recycle":
            sim.add_step(1, light.PhotonEmitterStep(8000, E=2.0))
        sim.add_step(2, phys.newton.NewtonianKinematicsStep())
        if case == "recycle":
            sim.add_step(3, light.ScatterDeleteStep(np.double(0.001),
                                                    np.double(0.001)))
            meas = light.ScatterSignMeasureStep(None, True)
            sim.add_photons(light.generate_photon_state(1000, E=1.0))
        elif case == "elist":
            meas = light.ScatterMeasureStep(
                None, True, measure_locs=[[2.5 * step_len, np.nan, np.nan]],
                measure_E=True)
            sim.add_photons(light.generate_photon_state(MP_TWIN_N,
                                                        E=E_tag))
        else:  # trace
            meas = light.TracePathMeasureStep()
            x0 = np.arange(MP_TRACE_N, dtype=np.float32)
            z = np.zeros(MP_TRACE_N, np.float32)
            sim.add_photons(light.generate_photon_state(
                MP_TRACE_N, E=1.0, r=np.stack([x0, z, z])))
        sim.add_step(4, meas)
        return sim, meas

    def records(case, sim, meas):
        if case == "trace":
            _, pos, alive, _ = meas.as_arrays()
            return [pos, alive]
        if case == "elist":
            return [np.array([r[2] for r in meas.data]),
                    np.asarray(meas.data[2][3], np.float32)]
        return [np.asarray(meas.data)]

    from physicl_tpu_torch.population import PopulationManager

    notes, boundary = [], {}
    for case in ("inject", "recycle", "elist", "trace"):
        runs = {}
        for where in (dev, "cpu"):
            sim, meas = build(case, where)
            spent = []
            undo = host_timer(PopulationManager, "maintain", spent)
            try:
                run_sim(torch, sim)
            finally:
                undo()
            if where == dev and spent:
                boundary[case] = max(spent) * 1e3
            check(sim.used_fused, f"across processes, {case} on {where}: "
                  "not fused")
            runs[where] = (sim, records(case, sim, meas))
        (cs, cr), (hs, hr) = runs[dev], runs["cpu"]
        check(np.asarray(cs.ts, np.float32).tobytes()
              == np.asarray(hs.ts, np.float32).tobytes(),
              f"across processes, {case}: sim.ts differs card against CPU")
        check(all(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
                  for a, b in zip(cr, hr)),
              f"across processes, {case}: records differ card against CPU")
        a, b = sim_planes(cs, torch), sim_planes(hs, torch)
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        check(not bad, f"across processes, {case}: planes {bad} differ "
              "card against CPU")
        extra = ""
        if case == "inject":
            n = cr[0][:, 1].astype(np.int64)
            check(n[0] == MP_TWIN_N and n[-1] == 2 * MP_TWIN_N
                  and int((np.diff(n) != 0).sum()) == 1,
                  f"across processes, inject: counts {np.unique(n)}")
            extra = f", {MP_TWIN_N} -> {2 * MP_TWIN_N} at one boundary"
        if case == "recycle":
            n_rec = [e[0] for e in cs.population_log].count("recycle")
            check(n_rec >= 1 and cs.population_log == hs.population_log,
                  f"across processes, recycle: {cs.population_log}")
            extra = f", {n_rec} recycles"
        if case == "elist":
            check(cr[0].tolist() == [0, 0, MP_TWIN_N, 0, 0, 0]
                  and np.array_equal(cr[1], E_tag),
                  f"across processes, elist: counts {cr[0].tolist()}")
            extra = f", {MP_TWIN_N} energies in slot order"
        if case == "trace":
            span = cs.sim_state.capacity // world
            check(runs[dev][1][0].shape[-1] == span
                  and next(s for s in cs.steps.values()
                           if hasattr(s, "col0")).col0 == rank * span,
                  "across processes, trace: not this process's span")
            extra = f", columns {rank * span}..{(rank + 1) * span - 1}"
        if case in boundary:
            extra += (f", slowest edit boundary {boundary[case]:.2f} ms "
                      "of host")
        notes.append(f"{case} ({len(cs.ts)} iterations{extra})")
        del runs, cs, hs
    return "; ".join(notes), boundary


def mp_worker(mode, rank, world, port, out):
    """``chip_smoke.py --mp-worker MODE RANK WORLD PORT OUT``: one process
    of a run across processes. ``card``: MP_WORLD processes share cuda:0
    over gloo, MP_SHARDS shards each; the main path, then
    :func:`mp_scenarios`. ``cards``: one process a card over NCCL; the
    main path with one shard and with MESH_SHARDS / world shards a
    process, :func:`mp_scenarios` with the latter, then
    :func:`gather_cost`. Loads the kernels the parent built; writes
    ``rank{r}.json`` (and ``.npz`` records) into ``out``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import physicl_tpu_torch as phys
    from physicl_tpu_torch.ops import _build
    from physicl_tpu_torch.ops import fused as F
    from physicl_tpu_torch.parallel import distributed as D
    from physicl_tpu_torch.parallel import init_distributed
    from physicl_tpu_torch.state import pad_capacity

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    dev = torch.device("cuda", 0 if mode == "card" else rank)
    torch.cuda.set_device(dev)
    _build.load()
    init_distributed(f"localhost:{port}", world, rank, timeout=MP_WAIT)
    res = {"backend": "nccl" if D.device_collectives() else "gloo",
           "build_seconds": _build.build_seconds}
    arrays = {}
    counts = [MP_SHARDS] if mode == "card" else [1, MESH_SHARDS // world]
    for k in counts:
        unit = pad_capacity(1) * k * world
        local = -(-MESH_N // unit) * unit // (k * world)
        keep = rank == 1 and mode == "card"
        run, kept = mp_main_run(torch, phys, F, dev, k,
                                keep_cap=local if keep else None)
        arrays[f"main{k}"] = run.pop("records")
        res[f"main{k}"] = run
        if kept:
            packed, sched, seed, k_act, _ = kept["args"]
            torch.save({"packed": packed.cpu(), "sched": sched.cpu(),
                        "seed": seed, "k": k_act},
                       os.path.join(out, "shard_args.pt"))
        del kept
        print(f"main path on {k * world} shards ({k} here): "
              f"{run['launches']} launches, chunks "
              f"{[round(x, 3) for x in run['chunks']]} ms", flush=True)
    res["scenarios"], res["boundary_ms"] = mp_scenarios(
        torch, phys, dev, rank, world, counts[-1])
    print(res["scenarios"], flush=True)
    if mode == "cards":
        res["gather"] = gather_cost(torch, phys, dev, counts[-1])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def gather_cost(torch, phys, dev, n_shards):
    """The host ms of assembling the global planes at an edit
    (``ShardedState.gather``: every process's shards all-gathered) on a pod
    mesh of ``n_shards`` shards a process, over NCCL (the device group)
    and staged through host memory over gloo (the path without a card of
    its own), at MP_TWIN_N and MESH_N photons, MP_GATHER_REPS times
    each."""
    from physicl_tpu_torch.parallel import distributed as D
    from physicl_tpu_torch.parallel import make_pod_mesh, shard_state
    from physicl_tpu_torch.parallel.sharding import ShardedState
    from physicl_tpu_torch.state import SimState, pad_capacity

    mesh = make_pod_mesh(devices=[dev] * n_shards)
    unit = pad_capacity(1) * len(mesh)
    out = {}
    for n in (MP_TWIN_N, MESH_N):
        st = SimState.from_population(
            [], [phys.light.generate_photon_state(n, E=1.0, device=dev)],
            device=dev, capacity=-(-n // unit) * unit)
        sh = shard_state(st, mesh)
        del st
        nbytes = sum(sum(x.numel() * x.element_size() for x in (
            *(getattr(s, f) for f in ("r", "dr", "v", "dv", "a", "E",
                                      "alive", "otype", "w")),
            *s.extras.values())) for s in sh.shards)
        for how in ("nccl", "staged"):
            group = D._device_group
            if how == "staged":
                # what a process without a card of its own takes: the
                # planes cross through host memory over gloo
                D._device_group = None
            times = []
            try:
                for _ in range(MP_GATHER_REPS):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    g = ShardedState(sh.shards, mesh).gather()
                    torch.cuda.synchronize(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
                    del g
            finally:
                D._device_group = group
            out[f"{how}{n}"] = times
        out[f"bytes{n}"] = nbytes
        del sh
        torch.cuda.empty_cache()
    return out


def mp_path(torch, dev, card, compare, mesh_ft, mesh_data, plan):
    """Phase: bench.py's main path across MP_WORLD processes sharing the
    card over gloo, MP_SHARDS shards each (8 in all, as phase 46): every
    launch variant 64 over one shard, the sign records of both processes
    bitwise equal to phase 46's one-process run; each process's chunk time
    on its own clock beside phase 46's; then the small runs of
    :func:`mp_scenarios` on every process; last, the first chunk of rank
    1's first shard (global shard 4) against the twin. Returns the
    kernels-line entry."""
    import shutil
    import tempfile

    from physicl_tpu_torch.state import pad_capacity

    phase(f"main path across {MP_WORLD} processes on one card: {MESH_N} "
          f"photons, {MP_SHARDS} shards a process, {MESH_CHUNKS} chunks of "
          f"{MESH_CHUNK}")
    out = tempfile.mkdtemp()
    try:
        res = spawn_workers("card", MP_WORLD, out,
                            env_of=lambda r: {"LOCAL_RANK": "0"})
        main = [r[f"main{MP_SHARDS}"] for r in res]
        for r, m in enumerate(main):
            with np.load(os.path.join(out, f"rank{r}.npz")) as z:
                data = z[f"main{MP_SHARDS}"]
            check(res[r]["backend"] == "gloo", f"rank {r} backend "
                  f"{res[r]['backend']}")
            check(m["seq_launches"] == m["launches"]
                  and m["launches"] >= MP_SHARDS * MESH_CHUNKS
                  and m["launches"] % MP_SHARDS == 0,
                  f"rank {r}: {m['seq_launches']} of {m['launches']} "
                  "launches ran variant 64")
            check(np.array_equal(data, mesh_data), f"rank {r}: sign records "
                  "differ from the one-process 8-shard run's")
            print(f"main-mp rank {r}: {m['launches']} launches, all variant "
                  f"64, sign records bitwise equal to phase 46's; chunk of "
                  f"{MESH_CHUNK} on its own clock "
                  f"{np.mean(m['chunks']):.3f} ms "
                  f"({[round(x, 3) for x in m['chunks']]}), between chunk "
                  f"events {[round(x, 3) for x in m['between']]}; records "
                  f"across processes at harvest "
                  f"{np.mean(m['records_ms']):.3f} ms of host a chunk "
                  f"({len(m['records_ms'])} chunks), the guard's row "
                  f"{np.mean(m['guard_ms']):.3f} ms a boundary; wall "
                  f"{m['wall']:.2f} s, set-up {m['setup']:.3f} s, peak "
                  f"{m['peak'] / 2 ** 30:.2f} GiB [{card}]", flush=True)
        ms = float(np.mean([x for m in main for x in m["chunks"]]))
        print(f"main-mp: {ms:.3f} ms a chunk over both processes, against "
              f"phase 46's {mesh_ft['ms']:.3f} ms (one process, 8 shards) "
              f"and {mesh_ft['unsharded_ms']:.3f} ms unsharded [{card}]",
              flush=True)
        for r in range(MP_WORLD):
            print(f"main-mp rank {r} on the card against the CPU twin, "
                  f"bitwise: {res[r]['scenarios']}", flush=True)
        args = torch.load(os.path.join(out, "shard_args.pt"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    unit = pad_capacity(1) * MESH_SHARDS
    cap = -(-MESH_N // unit) * unit
    local = cap // MESH_SHARDS
    k = args["k"]
    entry = {"plain_ms": compare("mp-shard4", args["packed"].to(dev),
                                 args["sched"].to(dev), min(k, TWIN_ITERS),
                                 plan, None, "main-mp", args["seed"],
                                 need_bitwise=True),
             "plain_iters": min(k, TWIN_ITERS), "plain_slots": local,
             "ms": ms, "launches": int(sum(m["launches"] for m in main)),
             "per_process_ms": [float(np.mean(m["chunks"])) for m in main]}
    entry["bound_ms"], entry["bound_by"] = transport_bound(plan, cap, k,
                                                           None)
    return entry


def mp_cards(torch, cards, card, mesh_n):
    """Phase, on a host with several cards: bench.py's main path with one
    process a card over NCCL (``LOCAL_RANK`` names it), one shard a card
    and MESH_SHARDS shards in all: each process's chunk times on its own
    clock, and the records equal on every process; the small runs of
    :func:`mp_scenarios` on every card against the CPU twin, bitwise; the
    cost of an edit's gather over NCCL against staging it through the host
    (:func:`gather_cost`)."""
    import shutil
    import tempfile

    phase(f"one process a card over {len(cards)} cards")
    out = tempfile.mkdtemp()
    try:
        res = spawn_workers("cards", len(cards), out,
                            env_of=lambda r: {"LOCAL_RANK": str(r)})
        for k in (1, MESH_SHARDS // len(cards)):
            datas = []
            for r in range(len(cards)):
                with np.load(os.path.join(out, f"rank{r}.npz")) as z:
                    datas.append(z[f"main{k}"])
            m = [x[f"main{k}"] for x in res]
            check(all(x["backend"] == "nccl" for x in res), "the "
                  "processes did not take NCCL")
            check(all(np.array_equal(d, datas[0]) for d in datas)
                  and bool((datas[0][:, 1] == mesh_n).all()),
                  f"one process a card, {k} shards each: records differ")
            for r, x in enumerate(m):
                print(f"one process a card, {k * len(cards)} shards: rank "
                      f"{r} chunk {np.mean(x['chunks']):.3f} ms "
                      f"({[round(v, 3) for v in x['chunks']]}), between "
                      f"chunk events {[round(v, 3) for v in x['between']]}"
                      f"; records across processes at harvest "
                      f"{np.mean(x['records_ms']):.3f} ms of host a chunk, "
                      f"the guard's row {np.mean(x['guard_ms']):.3f} ms a "
                      f"boundary [{card}]", flush=True)
        for r, x in enumerate(res):
            print(f"one process a card, rank {r} on its card against the "
                  f"CPU twin, bitwise: {x['scenarios']}", flush=True)
            g = x["gather"]
            for n in (MP_TWIN_N, mesh_n):
                print(f"one process a card, rank {r}: an edit's gather of "
                      f"{n} photons' planes ({g[f'bytes{n}']} B a process) "
                      f"over NCCL {[round(v, 3) for v in g[f'nccl{n}']]} "
                      f"ms, staged through the host over gloo "
                      f"{[round(v, 3) for v in g[f'staged{n}']]} ms of host "
                      f"[{card}]", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def mesh_cards_main():
    """``chip_smoke.py --mesh-cards``, on a host with several cards: the
    build, :func:`mesh_cards` over every card and :func:`mp_cards`,
    nothing else."""
    import torch

    check(torch.cuda.device_count() > 1, "--mesh-cards needs several cards")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import physicl_tpu_torch as phys
    from physicl_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    torch.cuda.set_device(0)
    phase("build")
    _build.load()
    cards = [torch.device("cuda", i) for i in
             range(torch.cuda.device_count())]
    mesh_cards(torch, phys, cards, card.splitlines()[0])
    mp_cards(torch, cards, card.splitlines()[0], MESH_N)


if __name__ == "__main__":
    if sys.argv[1:] == ["--mesh-cards"]:
        mesh_cards_main()
    elif sys.argv[1:2] == ["--mp-worker"]:
        mode, rank, world, port, out = sys.argv[2:7]
        mp_worker(mode, int(rank), int(world), int(port), out)
    else:
        main()
