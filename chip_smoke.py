#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (molchanica_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on lines of its own:
  1. the card (nvidia-smi name and power limit) and torch's CUDA version;
  2. build of the hand-written kernels from csrc/ (one nvcc per source,
     started together, sm_90a; linked into one library);
  3. the ~25k-site solvated polyalanine (config 3 of BASELINE.md) from the
     port's own builder, started from the committed eq25k.npz fixture, in
     FastSim with the benchmark's MdConfig;
  4. kernel parity: on the real L and Q subset tables after the first
     rebuild, every colpair instance the path runs (L/Q x force-only/
     energy) against its plain torch version on the same inputs;
  5. the FastSim path: a sim.step() warm-up and one timed call, then
     sim.potential_energy(); kernel launch counts over exactly that run;
  6. FastSim engine parity: the whole force of a fresh engine on the card
     against the same engine on the CPU (plain kernel twin), on the same
     state, through both force functions the path runs: force-only (the
     K-poly kernels of every step) and with energies (its terms too);
  7. MdSim on the same system, state and MdConfig plus use_pallas=True
     (method cells_pme, the cell-grid kernel K2): construction;
  8. K2 parity: on the real cell grid after the first rebuild, the CUDA
     kernel against its plain torch version on the same center rows and
     ghost array; its pair count and a second launch's bits; its device
     time and direct_force_work's model of the launch;
  9. the MdSim path: a warm-up call and one timed call; K2 launch counts
     over exactly those calls, against force_evals and against
     n + ceil(n/20) + 1 per call of at most steps_per_chunk steps;
 10. MdSim engine parity: force_fn on the card against the same MdSim on
     the CPU, on the initial state;
 11. the hydration system: methanol from the committed MolSpec
     (systems/data/methanol_gaff2.json) as the coupled molecule in a
     35 A OPC box, in FastSim with run_sol_sim_fast's MdConfig;
 12. K1d parity: on its real L and Q tables after the first rebuild,
     every has_alch colpair instance (L 'full' / Q 'coul' + water filter
     x force-only / energy) against its plain torch version, at couple
     0.5 and 0.05;
 13. alchemical engine parity at couple 0.5: the card's FastSim against
     the same engine on the CPU on one state (after a minimize on the
     card), force-only and energy force functions and dhdl;
 14. the TI path: run_sol_sim_fast on the card at the full box and all 13
     HYDRATION_LAMBDAS windows, shortened (--ti-equil, --ti-prod); K1d
     launch counts over exactly that call, against its force_evals;
 15. K1c: FastSim(per_slice_k=0) on config 3 at the same state (range
     tables); each range instance it runs (L/Q x force-only/energy)
     against its plain torch version on the real tables, then a warm-up
     and a timed step call (--range-warm, --range-steps) with launches
     counted against its force evaluations;
 16. K1f: the sharded colpair on config 3 (per-site sort, range tables,
     every site its own exclusion group): 8 ranks spawned on the one card
     over gloo (parallel/launch.py); on every rank the shard kernel
     against its plain version on the rank's local inputs, then
     --shard-calls sharded calls (energy and force-only) with launches
     counted per rank; the assembled forces and energies against the
     single-device K1c kernel on the same sorted state;
 17. parallel/dryrun.py::dryrun_multidevice(4, "gloo", "cuda");
 18. K1e: FastSim(triangular=False) on config 3 (the symmetric table,
     one kernel over the master array): a warm-up (--sym-warm; a per-slice
     table overflow replans there), both symmetric instances against their
     plain versions on the state's tables, the symmetric against the
     monolithic triangular kernel on one state and the symmetric against
     the default split engine, then a timed run(0.002, n, n/2)
     (--sym-steps) with its two snapshots, launches counted against the
     force evaluations; then FastSim(per_slice_k=0, triangular=False), its
     two symmetric range instances, and a short step call;
 19. K1e has_alch: FastSim(triangular=False) on the hydration state of
     phase 13 at couple 0.5, its two instances against their plain
     versions, 20 steps and one dhdl with launches counted;
 20. K1g: the cross variant, the solute subset per-site sorted on the
     master's column grid against the master array of phase 18's state:
     kernel against plain, the assembled f_i + f_j against the plain
     triangular kernel over the pairs with a solute site, 20 driven calls;
 21. P: the probe at the script's shapes and at S = 26,624 against
     probe_plain and the script's loop, then its main() on the card;
 22. NPT: FastSim on config 3 with the Berendsen barostat (P 1 bar,
     tau 2 ps), run(0.002, n, n/2) (--npt-steps); each period's pressure
     and box, the box moved, T in band, rigid waters, launches = 2 x the
     force evaluations;
 23. K2 against its plain version on two grids of random sites at water
     density, moved after the rebuild: capacity 128, and nc = 3;
 24. A: MdSim as a user gets it on config 3, MdConfig's defaults at the
     9 A cutoff and seed 7 (velocity-Verlet + CSVR, SHAKE, FIRE over 200
     iterations, use_pallas=False: the cluster-pair backend) from
     eq25k.npz's positions; FIRE's lowest state at least max(1% |E0|,
     10) below E0, the state kept at its energy, waters rigid;
 25. B: on A's state, every pair of real sites within rc found by a
     blocked brute-force search on the card lies in the [NC, M] cluster
     list; the cluster force on the card against the same function on
     the CPU and against the window backend on the card; device ms of a
     rebuild and of each backend's force evaluation;
 26. C: A's MdSim, a warm-up step call and a timed run(0.002, n, n/2)
     with two snapshots: ms/step, ns/day, T within 10% of 310 K
     (--mdd-profile N traces N more steps);
 27. D: NPT on the cluster path, BarostatCfg(1 bar, tau 2 ps) from C's
     state: each block's pressure by autograd, the peak memory of one
     pressure evaluation, the box moved, waters rigid;
 28. E: the verify recipe in vacuum: ethanol (allpairs, Langevin-middle,
     FIRE), compute_energy_snapshot under each MdOverrides ablation, the
     card's force against the CPU's (at the relaxed state against the
     CPU's float64 force), run(0.001, n, n/4);
 29. F: MdSim (cluster backend) on the hydration state of phase 13 at
     couple 0.5: the autograd dH/dlambda on the card against the CPU
     (rel 1e-5; the FD one within 8 of its float32 floors), then
     steps, T in band;
 30. G: the screening farm (scripts/bench_all.py's config-5 farm shape)
     on config 3 on K2: MdSim (Langevin gamma 5, FIRE 150, use_pallas)
     and ReplicaFarm(sim, 4, seed=3), 5 + 20 farm steps with K2 launches
     counted against the farm's force evaluations; on the diverged
     replicas one batched K2 launch against each replica's single launch
     (bitwise) and plain version (per slot and cell), pair counts; the
     batched launch's graph_ms beside 4 single launches'; T per replica;
     kernels per farm step (profiler), peak memory;
 31. H: the hydration farm: on phase 13's state one batched force of 13
     replicas against 13 single MdSim evaluations, and one farm step of
     two replicas card vs CPU with the same noise; then run_sol_sim at
     the reference protocol's width (13 windows, its own MdConfig on
     clusters) with the step counts cut (FIRE 100 of its 400, 20 + 22,
     dhdl every 10):
     ms per farm and window step, kernels per farm step, peak memory, the
     relaxation path, dG and SEM (not gated), each window's mean dH/dl
     beside its float32 FD floor; T per replica;
 32. I: LogP (run_alchemical) at its default boxes and LOGP_LAMBDAS, 20
     + 22 steps: each phase's sites, time and farm ms per step, finite,
     T per replica;
 33. J: the replica-TI dry run with its replica axis in two chunks on the
     card against one chunk, then the crystal, shrinking-box (with its
     mixing diagnostics) and boundary-layer workloads at small sizes;
 34. K: docking at the reference's pose budget: the committed pocket
     fixture (an 804-atom receptor, ibuprofen) through the port's PDB /
     SDF readers and GAFF2 chain, the site at the ligand's centroid
     (radius min(r, 9)), DockingSetup on the card and init_poses' 27,360
     poses; score_poses on the card against the CPU (clash masks, +inf
     totals, each term per pose within 1e-5 of its pair-term scale, the
     best ten totals), the fixture test's contract, poses/s, one batch
     under the profiler, peak memory, find_sites;
 35. L: MD shooting: the first shot's assembled system, its allpairs force
     card vs CPU (phase 28's gate), then dock_md_multi with N_SHOTS shots
     at dock_md's defaults but 200 steps (of 2 fs, 120 A/ps, float32, FIRE
     200): finite traces, each shot closer to the site than its start,
     the closest within 8 A; ms/step and FIRE wall time per shot;
 36. M: density and surface: density_from_atoms of the receptor (8 A
     margins, ~0.5 A spacing) card vs CPU, its structure factors back
     through density_map_from_sf on the card, sample_density at the atoms
     card vs CPU, density_rect around the ligand, the molecular surface of
     the site-culled receptor;
 37. N: the README's quick start on the committed ligand (ibuprofen):
     open_file, MolDynamics, build_dynamics with Langevin-middle at 310 K
     in OPC (FIRE 200, float32) at a pad of 11 A (2,289 sites, cells_pme;
     the README's 10 A gives 1,973 sites on allpairs_cutoff: printed,
     and its force card vs CPU at phase 28's gate), its force on the card
     against the CPU at the initial state (phase 10's gate), then
     run_dynamics_blocking(sim, 0.002, 400, 100):
     method, sites, box, FIRE wall time, ms/step, ns/day; finite, T in
     band, rigid waters, four snapshots;
 38. O: the same ligand on K2: the 35 A cube refused by K2's plan (no
     fallback), then build_dynamics in the 36 A cube with use_pallas
     (cells_pme, ~5.3k sites, FIRE on K2), K2 against its plain version on
     its grid, 300 + 100 (timed) steps with launches equal to the force
     evaluations;
 39. P: a checkpoint of O's card state restored bit for bit and two
     20-step continuations bitwise equal; launch_md of 20 more steps on
     its thread; N's snapshots written as DCD, TRR, XTC and GRO and read
     back (GRO through io.gro.read_gro_trajectory, the rest through
     Trajectory) within each format's precision;
     SnapshotViewer on the DCD;
 40. Q: screening: the committed therapeutic CSVs' 269 unique SMILES
     through from_smiles and write_sdf into a directory, then
     screen_ligs(auto_pharmacophore(ibuprofen), directory) on the card at
     its defaults (8 conformers, align): every ligand read and scored,
     the ligands that fall back (host preparation failed) the CPU port's,
     ligands/s, ms per ligand, peak memory; the first 32 ligands screened
     by the CPU port too: scores within 1e-9, each conformer's vacuum
     energy card vs CPU within 1e-5 of its sum of |terms|, the conformer
     candidates bit for bit, a best-conformer index apart only between
     the same candidate ranked by energies within that gate; one batch of
     8 conformers under the profiler (device ms, kernels, busy share);
     generate_conformers' defaults (32, FIRE 200 on the best) on the
     library's largest molecule (also its most flexible, 14 torsions) and
     the most flexible of the rest: the best energy lowered or kept,
     finite, the force at the final state on the card within 1e-4 of
     max|F| of the CPU's float64 force plus 4 x the CPU's own float32
     error (phase E's gate at a relaxed state);
 41. R: flexible_align of the top hit onto ibuprofen at its defaults
     (FIRE 200, 400 steps of 1 fs, k_pull 10): finite, the matched-pair
     RMSD after the pulled steps below its value after FIRE (which runs
     without the pull and leaves the rigid prealignment, as in the
     reference; the rigid RMSD printed beside), the force with the pull
     card vs CPU at the prealigned state within 1e-4 of max|F|, ms/step
     and FIRE s; find_hydrogen_bonds on N's last snapshot with its box:
     non-empty, every D-A <= 3.5 A and angle >= 120 deg; make_gromacs_input
     of N's assembled system: the .gro read back within 0.5e-3 nm plus
     float32 rounding, the .top's [ molecules ] counts the system's;
 42. S: ADME inference: the 27 committed weights files through the
     JAX-free loader (load ms per file), TherapeuticPredictor.predict_mols
     on the card over Q's 269 parsed molecules per target (ms per target,
     molecules/s, peak memory), every raw output against the port on the
     CPU within 1e-5 x (1 + |raw|), one forward under the profiler (device
     ms, kernels, busy share); compute_therapeutic_properties of 32 SMILES
     card vs CPU with the same NaN fields; caffeine over alendronate on
     hia_hou, warfarin over metformin by more than 20 on ppbr_az;
 43. T: train_target("logp_experimental") at the reference's defaults (50
     epochs, seed 0, 99 measured molecules) on the card and on the CPU port
     into temporary directories: the first 3 epochs' losses within 1e-3
     relative, held-out Pearson >= 0.6 on both, the saved file through
     TherapeuticPredictor(weights_path=...) predicting the test set bit
     for bit, no file under molchanica_tpu/ changed (sizes and mtimes); s
     per train_target, ms per optimizer step;
 44. U: ProteinMPNN at full width (K 48) on the backbone of a 250-residue
     build_polyalanine (seed 3), init_weights from a generator seeded 0:
     forward card (float32) vs CPU (float64) within 1e-4, rows summing to
     1 within 1e-5, one rigid motion within 1e-4; conditional_log_probs of
     all-A under one order card vs CPU float64 within 1e-4; 4
     design_sequences samples at T 0.1, each mean log-prob within 1e-5 of
     the teacher-forced decode of its sequence under the same order (over
     the 20 residues), no X; ddg_scan's wild-type column zero; forward
     device ms and kernels, ms and kernels per decode step, s per designed
     sequence;
 45. V: a protein from its sequence: HP35 (villin headpiece,
     LSDEDFKAVFGMTRSAFANLPLWKQQNLKKEKGLF) through predict_structure
     (baseline), write_mmcif / read_mmcif and prepare_peptide (the same
     MolSpec as a second pass of the chain, field for field), then
     MolDynamics(ff_mol_type="peptide", spec=...) and build_dynamics in
     OPC at phase N's MdConfig at a pad of 10 A (cells_pme): its force card
     vs CPU at the initial state (phase 10's gate), then
     run_dynamics_blocking(sim, 0.002, 400, 100): method, sites, box, FIRE
     s, ms/step, ns/day; finite, 100 K < T < 600 K, rigid waters, the
     protein's extent below 120 A. Then BASELINE config 2: the 12-mer
     ASGVLFKWPHTY prepared the same way, in vacuum at
     tests/test_peptide.py's MdConfig in float32 (FIRE 400), its force
     card vs CPU (phase 28's gate), 300 steps of 1 fs: finite, 100 K < T
     < 700 K, extent below 120 A;
 46. W: config 5's DNA duplex, MoleculeNucleicAcid.from_seq("GATTACA",
     double=True).to_spec() (440 atoms, net charge -12 within 1e-6),
     solvated and run as V's protein with V's gates;
 47. X: make_membrane() (32 PC lipids, 3,776 atoms) dry in its box at
     tests/test_lipid.py's MdConfig in float32, MdSim on the card, its
     force card vs CPU at the initial state, 100 steps of 1 fs at
     force_cap 1000: finite, T < 2,000 K, the leaflets' P atoms more than
     10 A apart in z; then MolEditor(device=None) through
     tests/test_editor.py's sequence: the stretched bond shorter by more
     than 0.1 A after 6 ticks, an O added mid-run (rebuilt lazily, 9
     atoms, finite); build and tick times;
 48. Y: the CLI (scripts/cli_phases.py runs it alone): one subprocess
     `python3 -m molchanica_tpu_torch "fetch glucose" "characterize"
     "energy" "minimize 50" "md 400" "predict caco2_wang CCO" "png ..."
     "session save ..."` on its default device, the card (rc 0, 24 atoms,
     every energy term within its printed precision of a CPU CliState's,
     md's T in 100-600 K, the PNG decoded here 900 x 700 with >= 1% ink,
     the session loaded on the CPU); meanwhile in this process the
     embedded tables without pandas (row and druglike counts, glucose),
     FastSim's general virtual-site path on phase 11's hydration system
     with its M weights jittered by 1% (force card vs CPU at phase 6's
     gate, 40 steps in the T band, every M at its construction within
     1e-5 A, K1 launches 2 x the force evaluations) and `bg md 200` with
     `energy` while it runs (the card's terms within 1e-8 of the largest
     term of the CPU's, the merged molecule moved); then config 3's
     current state as a 25k-site frame through render_snapshot's scene:
     primitives, fragments, the card's render ms after a warm-up, and
     >= 99.9% of its pixels within 2/255 of the same code on the CPU;
 49. the per-phase wall seconds (phase_seconds), the kernel JSON line, the
     card line, and the final JSON result line.
     Order and processes: G runs right after 23, so that its kernel time
     is taken while no other process shares the card. Then three worker
     processes (this script with --worker GROUP) run V-X; I-M; and N-U
     beside this process, which goes on with A-F, H and Y. Each
     worker's lines are printed after its group's name when it ends; a
     worker that fails fails the script at this process's next phase.
     Phases 24-29, H-N, Q-X and Y's CLI launch no hand-written kernel: the
     JAX package computes their direct space, scorer, shots, density,
     conformer energies and models in XLA (or numpy), and its CLI,
     renderer and tables reach no pallas_call, so the port does them in
     plain torch (or numpy).
An NVT hold (the mean temperature of further FastSim steps near 310 K)
runs only when --hold N asks for it.

Kernel parity is held to two gates. The whole-array one: max|dF|/max|F|
< 1e-4 and total energies rel < 1e-5. And one scaled per site: a force
error against the sum, over that site's pairs, of the magnitudes of the
terms each pair force is made of, an energy error against the same sum
over its i-cluster's (K1) or cell's (K2) pair energies (colpair_parity,
direct_force_parity). Excluded solute pairs enter the kernels at ~1e5
kcal/mol/A and are subtracted again, so the whole-array ratio alone would
let an error of a whole site force through everywhere else.

Every colpair instance checked against its plain version (phases 4, 12,
15, 16, 18-20) is also held to two more gates: the kernel's own count of
the pairs that passed its cutoff and mask test (the launch's `counts`
pointer) equals colpair_plain's count but for pairs whose float32 r^2
lies within NEAR_RC of rc^2 (counted on the plain side), so no in-cutoff
pair is dropped unseen; and each symmetric instance gives the same bits on
two launches. K2 (phases 8 and 23) is held to the same two: its count
equal to direct_force_plain's (the kernel's distance test is the plain
version's float32 expression), and the same bits on two launches. A
kernel time is the device's: 50 launches captured in one CUDA graph and
replayed (graph_ms), with the eager per-call time beside it and, for
colpair and K2, colpair_work's or direct_force_work's model of the launch
(chunks, compacted batches, lane use, warps per SM).

Fails (non-zero exit, no result line) without a CUDA device, outside a
checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "molchanica_tpu", "systems", "data",
                       "eq25k.npz")
# phases K-M: the committed pocket fixture (a collapsed 804-atom receptor
# and ibuprofen)
POCKET_PDB = os.path.join(ROOT, "molchanica_tpu", "systems", "data",
                          "pocket_fixture.pdb")
POCKET_SDF = os.path.join(ROOT, "molchanica_tpu", "systems", "data",
                          "pocket_ligand.sdf")
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per evaluated pair of csrc/colpair.cu (an FMA counts 2,
# rsqrt/exp/min/max 1): geometry, r^2 clamp and force accumulation 20, LJ
# with the C1 clamp 23, K-poly Coulomb 31 (degree 12), erfcx Coulomb 38,
# energy accumulation 4 (LJ) and 3 (Coulomb)
PAIR_OPS = {
    ("full", False): 20 + 23 + 31, ("coul", False): 20 + 31,
    ("lj", False): 20 + 23, ("full", True): 20 + 23 + 38 + 4 + 3,
    ("coul", True): 20 + 38 + 3, ("lj", True): 20 + 23 + 4,
}
# the has_alch instances (same counting): the softcore prelude (is_alch,
# alch, a_lj, soft_c, rsqrt(r2s + soft_c)) 14, Beutler LJ 23 + 7, erfcx
# Coulomb with the softcore force 38 + 5; never K-poly
PAIR_OPS_ALCH = {
    ("full", False): 20 + 14 + 30 + 43, ("coul", False): 20 + 14 + 43,
    ("full", True): 20 + 14 + 30 + 43 + 4 + 3,
    ("coul", True): 20 + 14 + 43 + 3,
}
# the symmetric table (K1e) accumulates no j reaction: three adds fewer
SYM_NO_REACTION_OPS = 3
K1_REPLACES = "molchanica_tpu/ops/pallas/colpair.py:810"
# FP32 operations per (i, j) pair of csrc/probe_prefetch.cu: the
# difference, its square added to the column sum (an FMA), the row sum
PROBE_PAIR_OPS = 4
PROBE_REPLACES = "scripts/probe_prefetch.py:32"
# FP32 operations per in-cutoff pair of csrc/direct_force.cu (same
# counting): geometry and r^2 clamp 10, softcore LJ with the clip 38, A&S
# Coulomb 30, force accumulation 7
K2_PAIR_OPS = 10 + 38 + 30 + 7
# K2 evaluates each in-cutoff pair from both of its cells; the least work
# for the same forces and energies is each pair once with its reaction,
# three adds more (K2's bound_ms; the pairs it evaluates: ordered_bound_ms)
K2_REACTION_OPS = 3
# K2 on two more grids (phase 23): (tag, seed, box, cutoff, sites per A^3).
# Random sites at the density of water's three atoms (0.1 per A^3) on a
# capacity-128 grid of 4 x 4 x 4 cells, and with OPC's M sites (0.134) on
# an nc = 3 grid at config 3's cutoff (capacity 256); moved after the
# rebuild, at couple 0.5 with the first sites coupled
K2_GRIDS = (("C=128", 1, (30.0, 31.0, 32.0), 7.0, 0.1),
            ("nc=3", 2, (28.0, 28.0, 28.0), 9.0, 0.134))
K2_GRID_MOVE = 0.3
K2_GRID_COUPLE = 0.5
K2_GRID_COUPLED = 5
# step counts of the earlier phases were cut (FastSim's timed call from
# 500, the TI windows' production from 60, the vacuum run from 2,000:
# run() keeps its four snapshots only where n/4 ends one of its chunks of
# 100 steps; the MD shots from 6) when the user-layer phases N-P (~80 s)
# took the whole script to 769 s on one H100. When the biomolecule phases
# V-X came, the whole script already took 891.5 s on one H100 (phase
# seconds: H 109, I 92, 14 57, L 57, J 50, N 49, O 45, G 45) and up to
# 1,257 s on slower hosts, so earlier depths were cut again, every gate
# kept: FastSim's warm-up 100 -> 50 and its timed call 300 -> 200, MdSim
# on K2 timed 200 -> 100, the TI windows 40 + 40 -> 10 + 10 (a dH/dlambda
# sample every 5, not 20: two per window still), the range tables' timed
# steps 100 -> 50, sharded calls 20 -> 10, FastSim NPT 200 -> 100, MdSim's
# warm-up 40 -> 20 and its NPT 200 -> 100, vacuum
# ethanol 800 -> 400, farm steps 50 -> 20, run_sol_sim's windows 40 + 66
# -> 20 + 22 (LogP's counts), FIRE before run_sol_sim's warm-ups 400 ->
# 100 iterations (FARM_FIRE), the properties' steps 150 -> 60 and stages
# 30 -> 15, the MD shots' steps 800 -> 200, O's warm-up 400 -> 300 and
# timed steps 200 -> 100 (O still ends 400 steps after FIRE, where N
# reads its lowest T). Phase Y's CLI runs `md 400`, not the CLI's default
# 1,000 steps (N_CLI_MD), to keep Y within its 45 s
N_TIMED = 200
N_WARM = 50
N_MD_TIMED = 100
N_MD_WARM = 40
# kernel vs plain, whole arrays: max|dF| / max|F| and total energy rel
KERNEL_TOL_F_MAX, KERNEL_TOL_E_TOT = 1e-4, 1e-5
# kernel vs plain, two float32 evaluations, per site and per i-cluster
# (colpair_parity). The plain version's own float32 floor against float64
# is at most 1.1e-6 and 6.6e-7 (tests/test_torch_colpair.py); a 1e-3 error
# in water O's LJ well depth gives 7e-4.
KERNEL_TOL_F, KERNEL_TOL_E = 1e-5, 1e-5
# engine card vs CPU, per site: 1e-4 of max|F| (PME, bonded and autograd
# sums) plus 1e-5 of the site's direct-space scale (colpair_plain's f_abs)
ENGINE_TOL_F, ENGINE_TOL_DIRECT = 1e-4, 1e-5
# the hydration phases: reference protocol box and lambda list, windows
# shortened to N_TI_EQUIL + N_TI_PROD steps with a dH/dlambda sample every
# TI_DHDL_INTERVAL; K1d held at two couplings where the softcore is large
TI_SEED = 3
N_TI_EQUIL = 10
N_TI_PROD = 10
TI_DHDL_INTERVAL = 5
ALCH_COUPLES = (0.5, 0.05)
# dhdl is a float32 central difference (h = 1e-3): card vs CPU within
# DHDL_FLOORS x eps32 * sum|terms| / 2h (the CPU tests hold the port to
# the JAX package within 4; the card sums in other orders, with atomics)
DHDL_H = 1e-3
DHDL_FLOORS = 8.0
# |<dH/dlambda>| per window above this is a blow-up (kcal/mol): a CPU
# rehearsal of phase 14 (24 A box, 6 A cutoff, same windows) stayed under
# 30 at every lambda, and so did this phase on an H100 (under 16); the
# run before the softcore fix (docs/TI_SHOWCASE.json) integrated to +1218
# kcal/mol
DHDL_BLOWUP = 500.0
# the range-table FastSim (phase 15) and the sharded colpair (phase 16):
# ranks on the one card, and sharded calls per variant. The assembled
# forces are held to 1e-4 of max|F| (the JAX package's 25k bound) and,
# per site and per i-cluster, to the kernel gates above
N_RANGE_WARM = 20
N_RANGE_STEPS = 50
N_SHARD = 8
N_SHARD_CALLS = 10
SHARD_TOL_F_MAX = 1e-4
# phases 18-22: the symmetric FastSim (warm-up, timed run with two
# snapshots), its range tables, its has_alch instances on the hydration
# system (steps and one dhdl), the cross variant (driven calls), the
# probe (the script's shapes, and S = 26,624 for 416 clusters), NPT
N_SYM_WARM = 20
N_SYM_STEPS = 100
N_SYM_RANGE_STEPS = 20
N_SYM_ALCH_STEPS = 20
N_CROSS_CALLS = 20
PROBE_BIG = (416, 8, 26624)
N_NPT_STEPS = 100
# phases 24-29 (MdSim's default engine): step counts
N_MDD_WARM = 20
N_MDD_STEPS = 100
N_MDD_NPT_STEPS = 100
N_VAC_STEPS = 400
N_MDD_ALCH_STEPS = 20
# phases G-J (the replica farm): G's replicas, warm-up and timed farm
# steps, and the farm steps of each profiler window; H's run_sol_sim step
# counts (the reference protocol's 5,000 + 20,000 cut); I's LogP step
# counts; J's windows of the replica-TI dry run and how far its split farm
# may part from the unsplit one (float32 roundoff)
N_FARM = 4
N_FARM_WARM = 5
N_FARM_STEPS = 20
FARM_PROFILE_STEPS = 3
H_EQUIL = 20
H_PROD = 22
H_DHDL_INTERVAL = 10
I_EQUIL = 20
I_PROD = 22
# H's relaxation before its capped warm-ups: FIRE over FARM_FIRE
# iterations, one of the reference protocol's blocks of 100 (it runs 400,
# 39.7 of H's 109 s on one H100), cut with the windows' steps; the
# windows then end at 787-805 K against 687-915 K after 400. LogP (I)
# keeps its 400: after 100 its wet-octanol windows blew up, both end
# points past 1e14 K (one H100)
FARM_FIRE = 100
J_WINDOWS = 4
J_SPLIT_TOL = 1e-5
# phases H and I: a lambda window whose final T is above WINDOW_BLOWUP_K
# has blown up. At the end points (lambda 0 and 1) that fails the phase.
# At an intermediate lambda it is the collapse that MdSim's linear
# alchemical Coulomb allows there (no softcore, as in the reference): the
# softcore LJ no longer holds a solute charge off an opposite solvent
# charge. The reference's own run_sol_sim shows it at H's earlier counts
# (FIRE 400, 40 + 66 steps; PERF.md, Open questions). Such a window is
# printed and left out of a second dG, beside run_sol_sim's own
WINDOW_BLOWUP_K = 1e4
# J's properties: crystal and boundary-layer steps, shrinking-box steps per
# stage (their JAX tests run 200, 450 and 60)
J_STEPS = 60
J_STAGE = 15
# phase K: the reference's pose budget (8^3 grid x 60 orientations, 27,360
# poses on the fixture), the site radius cap of tests/test_pocket_fixture.py,
# the scorer card vs CPU per term and pose within DOCK_TOL of the pose's
# pair-term scale (pose_term_magnitudes), plus the smallest normal float32
# per pair (a subnormal term), and the best DOCK_TOP totals compared as
# totals (near-tied poses may swap places)
DOCK_GRID = 8
DOCK_ORIENTATIONS = 60
DOCK_SITE_RADIUS = 9.0
DOCK_TOL = 1e-5
DOCK_TOP = 10
# phase L: MD shots at dock_md's defaults (2 fs, 120 A/ps, float32, FIRE
# 200) but SHOT_STEPS steps, not 800; the reference's dock_md_multi runs
# 8. On one H100 a shot took 9.4-13.6 s (9-16 ms per step, host-bound,
# FIRE ~2-3 s), so 8 shots (108.9 s on the slower host) overrun phases
# K-M's budget of about 120 s beside K's ~20 s; 6 fit until phases N-P
# came, then 4. A shot starts 8 A out (or 22-25 A where the receptor is
# in the way) at 120 A/ps, 0.24 A a step: 33-104 steps to the site
N_SHOTS = 4
SHOT_STEPS = 200
# phase M: the receptor's density in a cubic cell with DENSITY_MARGIN A on
# each side at about DENSITY_STEP A spacing, card vs CPU within DENSITY_TOL
# of max|rho|; atomic numbers of the fixture's elements
DENSITY_MARGIN = 8.0
DENSITY_STEP = 0.5
DENSITY_TOL = 1e-5
SAMPLE_TOL = 1e-9
ATOMIC_NUMBER = {"H": 1, "C": 6, "N": 7, "O": 8, "S": 16}
# phase E: the card's float32 force on relaxed ethanol against the CPU's
# float64 one, in units of the CPU's own float32 error against it
VAC_FLOORS = 4.0
# phase F: the autograd -dE/dcouple, card against CPU, relative
ALCH_MD_AUTOGRAD_REL = 1e-5
# Berendsen tau (ps): the reference's FastSim NPT test couples once per
# 10 steps of 1 fs at tau 0.5 ps, dt_eff / tau = 0.02 per application; at
# config 3's period of 20 steps of 2 fs the same ratio is tau = 2 ps. At
# tau = 0.5 (0.08 per period) the pressure swung from -1,847 to -6,882 bar
# with a growing amplitude over seven periods and the run blew up in the
# eighth (measured on one H100)
NPT_TAU = 2.0
# symmetric against triangular (one state, two tables) and the assembled
# cross forces against the plain triangular kernel restricted to pairs
# with a solute site: max|dF| / max|F|
SYM_TOL_F_MAX = 1e-4
# The two tables evaluate the same pairs: their float64 plain sums agree
# per site within SYM_TOL_F64 of the site's pair-term magnitudes. In
# float32 they part at pairs that cross a box face: the symmetric table
# evaluates such a pair from both of its sites, each adding the box length
# to the other's coordinate in float32, and at the stiff excluded solute
# pairs near the C1 clamp that rounding puts a site up to ~1.2e-5 of its
# magnitudes off the float64 sum. Config 3 on one H100 (phase 18's own
# prints): 1.154e-5 at eq25k's state, where the split engine's direct
# force sits 1.8e-7 off and the rest of the two engines' forces agree
# exactly; 8.4e-6 after the warm-up (a solute site 0.16 A from the face),
# against 1.6e-6 for the triangular kernel. That is above the per-site
# kernel gate, so a float32 comparison across the tables (kernels, or the
# symmetric against the split engine) is held per site to twice it,
# SYM_TOL_F. The gate still sees a fault: phase 18 runs the symmetric
# kernel with one cluster's own-slot entries emptied and with a 1e-3
# error in water O's well depth, and each must exceed SYM_TOL_F
SYM_TOL_F64, SYM_TOL_F = 1e-9, 2e-5
# the symmetric table's ordered pairs against twice the triangular table's
# unordered ones: a pair across a box face whose float32 r^2 lies within
# roundoff of the cutoff may count from one of its sites only
SYM_PAIRS_SLACK = 1e-6
# rigid waters after the NPT run: |d(O-H) - r_OH| (A)
RIGID_TOL = 5e-3
# phases N-P: the quick start (README) on the committed ligand, its
# run_dynamics_blocking(sim, 0.002, N_QS_STEPS, N_QS_STEPS // 4) at a pad
# of QS_PAD A. The README's pad of 10 A holds 485 OPC waters, 1,973 sites:
# under select_method's 2,048, so allpairs_cutoff (Coulomb cut at 9 A, no
# PME), where it heats to 1,652 K in 60 steps on one H100 (the --witness
# of scripts/user_layer_phases.py) and the JAX package's own quick start
# to 1,342 K in 50 (tests/test_torch_user_layer.py, the slow
# test_reference_quick_start_heats); 11 A is the smallest pad that
# reaches PME (2,289 sites, the cluster backend). A fresh water fill
# after FIRE releases heat in its first steps, which Langevin at gamma
# 1/ps bleeds off over a few ps (on one H100: 665 K at step 100, 584 K
# at 200, 498 K at 400, 391 K at 1,000; the JAX package on the CPU reads
# 731 K at step 100): hence 400 steps (the README runs 20,000), a
# snapshot every 100 (run() chunks at 100 steps, and an interval must
# end a chunk). Then the same ligand on K2 in a cube of O_BOX A, N_O_WARM
# + N_O_STEPS steps (the hydration protocol's 35 A box holds a cell of
# 241 sites at the 9 A cutoff, over K2's 256 slots less its 15% headroom,
# so MdSim refuses it: 36 A is the nearest cube whose 4^3 cells of 9 A
# K2 takes, 5,293 sites); then N_CKPT_STEPS steps from a checkpoint of
# O's state, twice, and N_CKPT_STEPS through launch_md
QS_PAD, QS_README_PAD = 11.0, 10.0
N_QS_STEPS = 400
O_BOX, O_REFUSED_BOX = 36.0, 35.0
N_O_WARM, N_O_STEPS = 300, 100
N_CKPT_STEPS = 20
# the two continuations from a restored checkpoint on the card must be
# bitwise equal: K2 is deterministic, and so is the rest of O's step on
# one H100 (max|dx| and max|dv| 0 over 20 steps), so the gate is zero.
# Trajectory formats read back: XTC at precision 1000/nm (0.5e-3 nm), GRO
# at 3 decimals in nm; DCD and TRR store float32
XTC_PRECISION = 1000.0
# phases Q-R: screening on the card. The library is the unique SMILES of
# the committed therapeutic CSVs (269), each through from_smiles and
# write_sdf into one directory that screen_ligs reads at its defaults (8
# conformers, align); the pharmacophore is auto_pharmacophore of the
# committed ligand (ibuprofen, 6 features). The CPU port screens the first
# N_SCREEN_CPU ligands too: scores within SCREEN_SCORE_TOL (the scorer is
# the same host code on the same coordinates), each conformer's float32
# vacuum energy within SCREEN_ENERGY_TOL of its sum of |terms| (bond,
# angle, dihedral, lj, coulomb). A force card vs CPU (FIRE's final
# conformer, the alignment's prealigned state with its pull) within
# CONF_TOL_F of max|F|, phase 28's gate for a dense vacuum force; at
# FIRE's final conformer, where max|F| is ~1, the card's float32 force is
# held to the CPU's float64 one within CONF_TOL_F of max|F| plus
# CONF_FLOORS x the CPU's own float32 error against it (the card's error
# read 0.97-0.98 x the CPU's on both molecules). The pull alone, card
# against float64 from the template, within PULL_ULPS x eps32 x k_pull
# (max|target| + max|x - target|), the rounding of its two float32 ops
SCREEN_CSV_GLOB = os.path.join(ROOT, "molchanica_tpu", "therapeutic",
                               "data", "*.csv")
N_SCREEN_CPU = 32
SCREEN_SCORE_TOL = 1e-9
SCREEN_ENERGY_TOL = 1e-5
CONF_TOL_F = 1e-4
CONF_FLOORS = 2.0
PULL_ULPS = 2.0
# phases S-U: the therapeutic models. S: every committed ADME weights file
# (27) through the JAX-free loader, TherapeuticPredictor.predict_mols on
# the card over Q's parsed library; each raw output (logit or scaled
# value) card vs the port on the CPU within ADME_TOL x (1 + |raw|), the
# float32 roundoff of two summation orders; compute_therapeutic_properties
# on the first N_PROPS_SMILES SMILES card vs CPU, and the two orderings of
# tests/test_measured_datasets.py (caffeine over alendronate on hia_hou,
# warfarin over metformin by more than PPBR_GAP on ppbr_az)
ADME_TOL = 1e-5
N_PROPS_SMILES = 32
PPBR_GAP = 20.0
ORDERINGS = (("hia_hou", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
              "NCCCC(O)(P(=O)(O)O)P(=O)(O)O", 0.0),
             ("ppbr_az", "CC(=O)CC(c1ccccc1)c1c(O)c2ccccc2oc1=O",
              "CN(C)C(=N)NC(=N)N", PPBR_GAP))
# T: train_target(TRAIN_TARGET) at the reference's defaults (50 epochs,
# seed 0) on the card and on the CPU port, into temporary directories: the
# first TRAIN_EPOCHS_HELD epochs' losses within TRAIN_LOSS_TOL relative
# (float32 in two summation orders; later epochs drift apart), held-out
# Pearson at least TRAIN_PEARSON_MIN (tests/test_therapeutic.py's floor)
TRAIN_TARGET = "logp_experimental"
TRAIN_EPOCHS_HELD = 3
TRAIN_LOSS_TOL = 1e-3
TRAIN_PEARSON_MIN = 0.6
# U: ProteinMPNN at its full width (K 48) on the N, CA, C, O of a
# 250-residue build_polyalanine(seed 3), init_weights from a generator
# seeded 0: the card's float32 log-probs within MPNN_TOL of the CPU's
# float64 (forward, and conditional_log_probs of all-A under one order),
# rows summing to 1 within MPNN_SUM_TOL, one rigid motion within MPNN_TOL;
# MPNN_SAMPLES designs at MPNN_T, each mean log-prob within
# MPNN_DESIGN_TOL of the teacher-forced decode of its sequence under the
# same order (renormalized over the 20 residues: design masks X out)
MPNN_RESIDUES = 250
MPNN_SEED = 3
MPNN_TOL = 1e-4
MPNN_SUM_TOL = 1e-5
MPNN_SAMPLES = 4
MPNN_T = 0.1
MPNN_DESIGN_TOL = 1e-5
# the decode steps traced at the main path's shapes: the first
# MPNN_PROFILE_STEPS of the 250-residue, K 48 decode (a trace of all 250,
# ~36k kernels, takes 6-9 s to read)
MPNN_PROFILE_STEPS = 50
# phases V-X: the biomolecule builders. V: HP35, the villin headpiece
# subdomain, from its sequence through the baseline predictor, an mmCIF
# round trip (a heavy-atom file, as from a download) and prepare_peptide,
# then build_dynamics in OPC at the quick start's MdConfig (phase N's) at a
# pad of BIO_PAD A and run_dynamics_blocking(sim, 0.002, N_BIO_STEPS,
# N_BIO_STEPS // 4): finite, phase N's T band, waters rigid, the solute's
# extent below BIO_EXTENT A (the bound of tests/test_peptide.py); then
# BASELINE config 2, tests/test_peptide.py's 12-mer in vacuum at that
# test's MdConfig in float32 (Langevin-middle gamma 5 at 300 K, SHAKE, FIRE
# 400) for N_CONFIG2_STEPS steps of 1 fs, 100 K < T < CONFIG2_T_MAX. W:
# config 5's duplex of DUPLEX_SEQ (net charge -12 within
# DUPLEX_CHARGE_TOL) at V's MdConfig and gates. X: make_membrane() dry at
# tests/test_lipid.py's MdConfig in float32 (7 A cutoffs, Langevin-middle
# gamma 5 at 310 K, SHAKE, FIRE 200, chunks of 50), N_MEMBRANE_STEPS steps
# of 1 fs at MEMBRANE_FORCE_CAP: finite, T below MEMBRANE_T_MAX (the
# reference's gate), the leaflets' P atoms more than LEAFLET_GAP A apart
# in z; then MolEditor on the card through tests/test_editor.py's sequence
# (ethane, its second carbon pulled 1.6x out along the C-C bond,
# N_EDITOR_TICKS ticks: the bond shorter by more than EDITOR_RELAX A; an O
# added mid-run)
HP35_SEQ = "LSDEDFKAVFGMTRSAFANLPLWKQQNLKKEKGLF"
CONFIG2_SEQ = "ASGVLFKWPHTY"
DUPLEX_SEQ = "GATTACA"
BIO_PAD = 10.0
N_BIO_STEPS = 400
N_CONFIG2_STEPS = 300
CONFIG2_T_MAX = 700.0
BIO_EXTENT = 120.0
DUPLEX_CHARGE_TOL = 1e-6
N_MEMBRANE_STEPS = 100
MEMBRANE_FORCE_CAP = 1000.0
MEMBRANE_T_MAX = 2000.0
LEAFLET_GAP = 10.0
N_EDITOR_TICKS = 6
EDITOR_RELAX = 0.1
# phase Y (the CLI): `md` runs N_CLI_MD steps, not the CLI's default
# 1,000, to keep the phase within its 45 s; predict reads a target that
# nothing in this script retrains (T writes logp_experimental). The CLI
# prints energies to 4 decimals; the card's terms against the CPU's within
# CLI_ENERGY_TOL of the largest term (float64). The 25k frame rasterized
# on the card against the same code on the CPU: RENDER_SHARE of the
# pixels within RENDER_TOL / 255 in every channel. FastSim's general vsite
# path on the hydration system with each water's M weight scaled by
# 1 + VSITE_JITTER N(0, 1) (seed VSITE_SEED), N_VSITE_STEPS steps, every M
# at its construction within VSITE_TOL; the same start on the unjittered
# system down the rolled path and (one reordered row) the gather path, T
# within VSITE_T_REL of each other. The embedded tables' rows and
# druglike rows as tests/test_torch_mol_db.py pins them.
N_CLI_MD = 400
N_BG_MD = 200
CLI_TARGET = "caco2_wang"
CLI_ENERGY_TOL = 1e-8
CLI_PRINT_TOL = 5e-5
CLI_PNG_FG = 0.01
RENDER_TOL, RENDER_SHARE = 2, 0.999
VSITE_JITTER, VSITE_SEED, VSITE_TOL = 0.01, 5, 1e-5
N_VSITE_STEPS = 40
VSITE_T_REL = 0.05
DB_ROWS = {"metabolites_hmdb_core": (91, 81),
           "compounds_chebi_core": (41, 40)}
# The phases after G take no time or launch count of the kernel line and
# depend on no state of the main process but the phases it keeps (A-F,
# H, Y), so three worker processes run the rest beside it on the same
# card, each group in its order: V-X; I-M; N-U (Q's library feeds S and
# T). One process of all 49 phases took 909-967 s of the 1,200 s limit
# on one H100 (phase seconds: V 123, I 90, H 62, W 60, N 47, A 40) and
# more on a slower host; with the workers, 580.8-598.5 s. Every process
# after the split gets WORKER_THREADS CPU threads (4 x 2 on the 8
# cores); a worker still running WORKER_DEADLINE s after the script
# started is killed and fails the run
WORKER_GROUPS = ("VWX", "IJKLM", "NOPQRSTU")
WORKER_THREADS = 2
WORKER_DEADLINE = 1100.0


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n):
    """Mean device ms of fn() over n calls, after one warm call."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def graph_ms(fn, n):
    """Device ms per call of fn(): n calls captured in one CUDA graph,
    timed over one replay after a warm one, so the host's cost per call
    (the wrapper's checks and allocations) stays out. cuda_ms over eager
    calls measures the host instead once a call's device time falls
    below it."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def engine_instances(sim, torch):
    """(kernel, rows, wl, nw) of every colpair instance the engine runs, on
    its state's tables: the L and Q subsets of the species split (force-only
    and energy each), or the master table of the monolithic kernel."""
    st = sim.state
    x_v = sim._apply_vsites(st.x, st, st.box)
    if sim._split is None:
        rows = torch.cat([x_v, st.props], 1)
        return [(sim._direct[we], rows, st.wl, st.nw) for we in (False, True)]
    sp = st.split
    x_ext = torch.cat([x_v, torch.full((1, 3), 1.0e6, device=x_v.device)])
    out = []
    for key in ("l", "q"):
        rows = torch.cat([x_ext[sp[f"idx_{key}"]], sp[f"props_{key}"]], 1)
        for we in (False, True):
            out.append((sim._split["kernels"][we][key.upper()], rows,
                        sp[f"wl_{key}"], sp[f"nw_{key}"]))
    return out


def pair_ops(cfg) -> int:
    """FP32 operations per evaluated pair of a colpair instance."""
    table = PAIR_OPS_ALCH if cfg.has_alch else PAIR_OPS
    ops = table[(cfg.mode, cfg.want_energy)]
    if not cfg.triangular and cfg.cross is None:
        ops -= SYM_NO_REACTION_OPS
    return ops


def pair_count_check(name, count, stats):
    """The kernel's pair counter against colpair_plain's count on the same
    inputs: equal, or apart by no more than the pairs whose float32 r^2
    lies within NEAR_RC of rc^2 (an fma moves r^2 by an ulp there)."""
    from molchanica_tpu_torch.ops.colpair import NEAR_RC

    p, near = stats["pairs"], stats["pairs_near_rc"]
    say(f"[pairs] {name}: kernel {count}, plain {p}, |diff| "
        f"{abs(count - p)} (allowed {near}: pairs with r^2 within "
        f"{NEAR_RC:g} rc^2 of rc^2)")
    if abs(count - p) > near:
        raise SystemExit(f"{name}: the kernel counted {count} pairs, the "
                         f"plain version {p}")


def work_line(work, n_sm) -> str:
    """colpair_work's model of one launch, for the time lines."""
    return (f"{work['blocks']} blocks ({work['parts']} parts), "
            f"{work['warps'] / n_sm:.1f} warps per SM launched, "
            f"{work['busy_warps'] / n_sm:.1f} with a chunk; {work['chunks']} "
            f"chunks ({work['slots']} j slots, {work['tested']} slot pairs "
            f"tested, at most {work['max_warp_chunks']} per warp, "
            f"{work['max_cluster_chunks']} per cluster), {work['pairs']} "
            f"pairs in {work['batches']} batches, lane use "
            f"{work['lane_use']:.3f}")


def work_counts(work) -> dict:
    """colpair_work's counts, without its per-chunk table and keys."""
    return {k: v for k, v in work.items() if k not in ("table", "keys")}


def instance_parity(kern, rows, pT, wl, nw, box, torch, couples=(None,),
                    couple0=None):
    """One colpair instance against colpair_plain on the same inputs, at
    each coupling in `couples` (None: `couple0`, the state's own); timed
    at the first. Two-output instances (cross) are compared over their i
    rows and j slots together; the kernel's pair counter is held to the
    plain count (pair_count_check), and a symmetric instance to the same
    bits on a second launch. Returns its JSON kernel entry, with the
    worst errors over `couples` and the plain run's stats."""
    from molchanica_tpu_torch.ops.colpair import (ICL, colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain,
                                                  colpair_work)

    dev = rows.device
    cpls = [couple0 if c is None else
            torch.tensor(c, dtype=torch.float32, device=dev) for c in couples]
    S = rows.shape[0]
    sym = not kern.cfg.triangular and kern.cfg.cross is None
    worst = dict(err=0.0, rel_f=0.0, rel_e=0.0)
    for c, cpl in zip(couples, cpls):
        at = "" if c is None else f" couple={c:g}"
        n_k = torch.zeros(1, dtype=torch.int64, device=dev)
        out_k = colpair_cuda(kern.cfg, rows, pT, wl, nw, box,
                             kern.params(dev), cpl, counts=n_k)
        if sym:
            again = colpair_cuda(kern.cfg, rows, pT, wl, nw, box,
                                 kern.params(dev), cpl)
        stats = {}
        out_p = colpair_plain(rows, pT, wl, nw, box, kern.cfg, cpl,
                              stats=stats)
        torch.cuda.synchronize()
        pair_count_check(kern.name + at, int(n_k), stats)
        if sym:
            same = all(torch.equal(a, b) for a, b in zip(out_k, again))
            say(f"[parity] {kern.name}{at}: two launches bitwise equal: "
                f"{same}")
            if not same:
                raise SystemExit(f"{kern.name}{at}: the symmetric kernel "
                                 "is not deterministic")
        f_k, e_k = torch.cat(out_k[:-1]), out_k[-1]
        f_p, elj_p, ec_p = torch.cat(out_p[:-2]), out_p[-2], out_p[-1]
        rel_f, rel_e = colpair_parity(f_k, e_k.sum(1), f_p, stats)
        err = float((f_k - f_p).abs().max())
        f_max = float(f_p.abs().max())
        e_kern = float(e_k.sum())
        e_plain = float(elj_p + ec_p)
        rel_tot = abs(e_kern - e_plain) / max(abs(e_plain), 1e-30)
        say(f"[parity] {kern.name}{at} S={S} NC={S // ICL} "
            f"max_entries={int(nw.max())} pairs={stats['pairs']} "
            f"max|dF|/max|F|={err / f_max:.3e} (max|dF|={err:.4e}, "
            f"max|F|={f_max:.4e}) e_kernel={e_kern:.6f} "
            f"e_plain={e_plain:.6f} rel_e={rel_tot:.3e} "
            f"(limits {KERNEL_TOL_F_MAX:g}, {KERNEL_TOL_E_TOT:g})")
        say(f"[parity] {kern.name}{at} per site max|dF|/scale="
            f"{rel_f:.3e}, per cluster |dE|/scale={rel_e:.3e} "
            f"(limits {KERNEL_TOL_F:g}, {KERNEL_TOL_E:g})")
        if not (err / f_max < KERNEL_TOL_F_MAX
                and rel_tot < KERNEL_TOL_E_TOT
                and rel_f < KERNEL_TOL_F and rel_e < KERNEL_TOL_E):
            raise SystemExit(f"{kern.name}{at}: kernel and plain "
                             "disagree")
        worst = dict(err=max(worst["err"], err),
                     rel_f=max(worst["rel_f"], rel_f),
                     rel_e=max(worst["rel_e"], rel_e))
    launch = lambda: colpair_cuda(kern.cfg, rows, pT, wl, nw, box,
                                  kern.params(dev), cpls[0])
    ms, call_ms = graph_ms(launch, 50), cuda_ms(launch, 50)
    plain_ms = cuda_ms(lambda: colpair_plain(rows, pT, wl, nw, box,
                                             kern.cfg, cpls[0]), 3)
    ops = stats["pairs"] * pair_ops(kern.cfg)
    work = colpair_work(rows, pT, wl, nw, box, kern.cfg)
    if sym:
        # the symmetric table evaluates each unordered pair from both of
        # its sites; the least work for the same forces and energies is
        # each pair once, with its reaction (the triangular count)
        ordered_ops = ops
        ops = stats["pairs"] / 2 * (pair_ops(kern.cfg) + SYM_NO_REACTION_OPS)
    two_out = len(out_k) == 3
    nbytes = (rows.numel() + pT.numel() + wl.numel() + nw.numel()
              + 3 + 64 + int(kern.cfg.has_alch)) * 4 \
        + (S * 3 + (pT.shape[1] * 3 if two_out else 0)
           + (S // ICL) * 2) * 4
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    entry = dict(
        name=kern.name, route="cuda",
        source="molchanica_tpu_torch/csrc/colpair.cu", replaces=K1_REPLACES,
        launches=0, max_abs_err=worst["err"], ms=ms, plain_ms=plain_ms,
        call_ms=call_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, pairs=stats["pairs"], kernel_pairs=int(n_k),
        pairs_near_rc=stats["pairs_near_rc"], S=S, bytes=nbytes,
        site_rel_err=worst["rel_f"], cluster_rel_err_e=worst["rel_e"],
        work=work_counts(work))
    if sym:
        entry.update(ordered_bound_ms=max(ordered_ops / PEAK_FP32 * 1e3,
                                          t_bytes))
    say(f"[time] {kern.name}: kernel {ms:.4f} ms (device; {call_ms:.4f} ms "
        f"per eager call), plain {plain_ms:.3f} ms, "
        f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}; "
        + (f"{stats['pairs'] // 2} unordered pairs x "
           f"{pair_ops(kern.cfg) + SYM_NO_REACTION_OPS} FP32 ops; the "
           f"{stats['pairs']} ordered pairs x {pair_ops(kern.cfg)} it "
           f"evaluates {entry['ordered_bound_ms']:.5f} ms)" if sym else
           f"{stats['pairs']} pairs x {pair_ops(kern.cfg)} FP32 ops)"))
    say(f"[work] {kern.name}: "
        + work_line(work, torch.cuda.get_device_properties(dev)
                    .multi_processor_count))
    return entry


def kernel_parity(sim, torch, couples=(None,)):
    """Each colpair instance of the engine's path vs colpair_plain on the
    state's tables, at each coupling in `couples` (None: the state's own,
    for the instances without has_alch). Returns one JSON kernel entry per
    instance."""
    return [instance_parity(kern, rows, rows.T.contiguous(), wl, nw,
                            sim.state.box, torch, couples, sim.state.couple)
            for kern, rows, wl, nw in engine_instances(sim, torch)]


def engine_parity(build, torch, lam=None, tag="engine"):
    """The card's force against the CPU engine's on the same state, for the
    force-only function (the K-poly kernels of every step; with a coupled
    solute, the erfcx has_alch kernels) and the one with energies (whose
    terms must agree to rel 1e-5 too). Per site the limit is ENGINE_TOL_F
    of max|F| plus ENGINE_TOL_DIRECT of the site's direct-space scale (the
    plain kernels' f_abs, owned and spread like the force): excluded solute
    pairs enter the kernel at ~1e5 kcal/mol/A and are subtracted again,
    which leaves a float32 floor at those sites only (see
    tests/test_torch_fast_engine.py). With `lam`, both engines are set to
    that lambda window and dhdl must agree within DHDL_FLOORS of its
    float32 floor. Returns the card's dhdl (or None)."""
    import numpy as np

    from molchanica_tpu_torch.ops.colpair import colpair_plain

    t0 = time.perf_counter()
    sim = build("cuda")
    cpu = build("cpu")
    if lam is not None:
        sim.configure_alchemical_window(lam)
        cpu.configure_alchemical_window(lam)
    st_c = cpu.state
    st_g = sim.state.replace(x=st_c.x.to(sim.device))
    if not torch.equal(sim.state.perm.cpu(), st_c.perm):
        raise SystemExit("engine parity: CPU and card sorts differ")
    sp = st_c.split
    with torch.no_grad():
        x_v = cpu._apply_vsites(st_c.x, st_c, st_c.box)
        x_ext = torch.cat([x_v, torch.full((1, 3), 1.0e6)])
        f_abs = []
        for key in ("l", "q"):
            rows = torch.cat([x_ext[sp[f"idx_{key}"]], sp[f"props_{key}"]], 1)
            stats = {}
            colpair_plain(rows, rows.T.contiguous(), sp[f"wl_{key}"],
                          sp[f"nw_{key}"], st_c.box,
                          cpu._split["kernels"][False][key.upper()].cfg,
                          st_c.couple, stats=stats)
            f_abs.append(stats["f_abs"])
        comb = torch.cat([*f_abs, torch.zeros(1)])
        a = (comb[sp["gsrc_l"]] + comb[sp["gsrc_q"]])[:, None].repeat(1, 3)
        a = cpu._spread_vsite_forces(a, st_c)[:, 0]
        for we in (False, True):
            fg, (_, tg) = sim._make_force_fn(we)(st_g.x, st_g)
            fc, (_, tc) = cpu._make_force_fn(we)(st_c.x, st_c)
            err = (fg.cpu() - fc).abs().amax(dim=1)
            f_max = float(fc.abs().max())
            tol = ENGINE_TOL_F * f_max + ENGINE_TOL_DIRECT * a
            worst = int(torch.argmax(err / tol))
            terms = ("bond", "angle", "dihedral", "recip") + (
                ("lj", "coulomb") if we else ()) + (
                ("comp",) if "comp" in tc else ())
            worst_e = max(abs(float(tg[k]) - float(tc[k]))
                          / max(abs(float(tc[k])), 1e-30) for k in terms
                          if float(tc[k]) != 0.0 or float(tg[k]) != 0.0)
            say(f"[{tag}] {'energy' if we else 'force-only'}: card vs CPU "
                f"on one state: max|dF|={float(err.max()):.4f} "
                f"(max|F|={f_max:.2f}); worst site {worst}: |dF|="
                f"{float(err[worst]):.4f} against limit "
                f"{float(tol[worst]):.4f} (direct scale "
                f"{float(a[worst]):.4e}); worst energy term rel "
                f"{worst_e:.2e}")
            if not (bool((err <= tol).all()) and worst_e < 1e-5):
                raise SystemExit(f"{tag} parity failed")
        d_g = d_c = None
        if lam is not None:
            sim.state = st_g
            d_g, d_c = sim.dhdl(), cpu.dhdl()
            floor = float(np.finfo(np.float32).eps) * sum(
                abs(float(tc[k])) for k in ("bond", "angle", "dihedral",
                                            "recip", "lj", "coulomb")) \
                / (2.0 * DHDL_H)
            say(f"[{tag}] dhdl at lambda={lam:g}: card {d_g:.4f} CPU "
                f"{d_c:.4f} kcal/mol, |diff| {abs(d_g - d_c):.4f} against "
                f"{DHDL_FLOORS:g} x float32 floor {floor:.4f}; comp term "
                f"card {float(tg['comp']):.6f} CPU {float(tc['comp']):.6f}")
            if not (np.isfinite(d_g)
                    and abs(d_g - d_c) <= DHDL_FLOORS * floor):
                raise SystemExit(f"{tag}: dhdl parity failed")
    say(f"[{tag}] CPU engine and checks {time.perf_counter() - t0:.1f} s")
    return d_g


def k2_check(tag, plan, direct, center, ghost, couple, beta, torch):
    """K2 (csrc/direct_force.cu) against direct_force_plain on one cell
    grid: per slot and per cell within KERNEL_TOL_F / KERNEL_TOL_E of the
    pair-term magnitudes, total energy within KERNEL_TOL_E_TOT; the kernel's
    pair count (its `counts` pointer) equal to the plain count; two
    launches the same bits. Returns (errors, plain stats, kernel output)."""
    from molchanica_tpu_torch.ops.direct_force import (cell_energies,
                                                       direct_force_cuda,
                                                       direct_force_parity,
                                                       direct_force_plain)

    n_k = torch.zeros(1, dtype=torch.int64, device=center.device)
    out_k = direct_force_cuda(plan, center, ghost, couple, beta, counts=n_k)
    again = direct_force_cuda(plan, center, ghost, couple, beta)
    stats = {}
    out_p = direct_force_plain(center, ghost, direct.starts, couple, beta,
                               direct.rc2, stats=stats)
    torch.cuda.synchronize()
    same = torch.equal(out_k, again)
    e_k = cell_energies(out_k, plan.n_cells)
    e_p = cell_energies(out_p, plan.n_cells)
    rel_f, rel_e = direct_force_parity(out_k[:, :3], e_k.sum(1),
                                       out_p[:, :3], stats)
    err = float((out_k[:, :3] - out_p[:, :3]).abs().max())
    f_max = float(out_p[:, :3].abs().max())
    tot_k, tot_p = float(e_k.sum()), float(e_p.sum())
    rel_tot = abs(tot_k - tot_p) / max(abs(tot_p), 1e-30)
    S = center.shape[0]
    say(f"[parity] {tag} nc={plan.nc} cells={plan.n_cells} "
        f"C={plan.capacity} S={S} G={ghost.shape[1]} "
        f"real={int((center[:, 7] > 0.5).sum())} pairs={stats['pairs']} "
        f"slots={S * 9 * 3 * plan.capacity} "
        f"max|dF|/max|F|={err / f_max:.3e} (max|dF|={err:.4e}, "
        f"max|F|={f_max:.4e}) e_kernel={tot_k:.6f} e_plain={tot_p:.6f} "
        f"rel_e={rel_tot:.3e} (e_lj {float(e_k[:, 0].sum()):.4f} / "
        f"{float(e_p[:, 0].sum()):.4f}, e_c {float(e_k[:, 1].sum()):.4f} / "
        f"{float(e_p[:, 1].sum()):.4f})")
    say(f"[parity] {tag} per slot max|dF|/scale={rel_f:.3e}, per cell "
        f"|dE|/scale={rel_e:.3e} (limits {KERNEL_TOL_F:g}, "
        f"{KERNEL_TOL_E:g}; total energy {KERNEL_TOL_E_TOT:g})")
    say(f"[pairs] {tag}: kernel {int(n_k)}, plain {stats['pairs']}; two "
        f"launches bitwise equal: {same}")
    if not (rel_f < KERNEL_TOL_F and rel_e < KERNEL_TOL_E
            and rel_tot < KERNEL_TOL_E_TOT):
        raise SystemExit(f"{tag}: kernel and plain disagree")
    if int(n_k) != stats["pairs"]:
        raise SystemExit(f"{tag}: the kernel counted {int(n_k)} pairs, the "
                         f"plain version {stats['pairs']}")
    if not same:
        raise SystemExit(f"{tag}: two launches differ")
    return (dict(err=err, rel_f=rel_f, rel_e=rel_e, rel_tot=rel_tot,
                 kernel_pairs=int(n_k)), stats, out_k)


def k2_work_line(work) -> str:
    """direct_force_work's model of one launch, for the time lines."""
    return (f"{work['active_blocks']} of {work['blocks']} blocks active "
            f"({work['parts']} parts per cell), {work['warps_per_sm']:.1f} "
            f"warps per SM; {work['scanned']} slots scanned, {work['real']} "
            f"real, {work['staged']} staged, {work['tested']} pairs tested "
            f"in {work['chunks']} chunks (at most {work['max_warp_chunks']} "
            f"per warp), {work['pairs']} pairs in {work['batches']} batches, "
            f"lane use {work['lane_use']:.3f}; math batches per SM "
            f"{work['sm_batches_mean']:.1f} mean, {work['sm_batches_max']} "
            f"max")


def k2_parity(md, torch):
    """Phase 8: K2 against direct_force_plain on MdSim's cell grid of the
    state after its first rebuild (k2_check), timed by graph_ms with the
    eager time beside it and direct_force_work's model of the launch.
    Returns its JSON entry."""
    from molchanica_tpu_torch.md.energy import apply_virtual_sites
    from molchanica_tpu_torch.ops.direct_force import (direct_force_cuda,
                                                       direct_force_plain,
                                                       direct_force_work)

    s = md.state
    plan, direct = md._plan, md._direct
    xv = apply_virtual_sites(s.positions, md.top)
    sa, _, ovf = md._rebuild(xv, s.box)
    center, ghost = direct.inputs(xv, s.box, sa)
    args = (s.couple, md._beta)
    say(f"[parity] direct_force overflow={int(ovf)}")
    errs, stats, out_k = k2_check("direct_force", plan, direct, center,
                                  ghost, *args, torch)
    launch = lambda: direct_force_cuda(plan, center, ghost, *args)
    ms, call_ms = graph_ms(launch, 50), cuda_ms(launch, 50)
    plain_ms = cuda_ms(lambda: direct_force_plain(
        center, ghost, direct.starts, *args, direct.rc2), 3)
    n_sm = torch.cuda.get_device_properties(center.device) \
        .multi_processor_count
    work = direct_force_work(center.cpu(), ghost.cpu(), direct.starts.cpu(),
                             direct.rc2, n_sm)
    t_ops = (stats["pairs"] / 2 * (K2_PAIR_OPS + K2_REACTION_OPS)
             / PEAK_FP32 * 1e3)
    t_ordered = stats["pairs"] * K2_PAIR_OPS / PEAK_FP32 * 1e3
    nbytes = (center.numel() + ghost.numel() + 2 + out_k.numel()) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    S = center.shape[0]
    entry = dict(
        name="direct_force", route="cuda",
        source="molchanica_tpu_torch/csrc/direct_force.cu",
        replaces="molchanica_tpu/ops/pallas/direct_force.py:156",
        launches=0, max_abs_err=errs["err"], ms=ms, plain_ms=plain_ms,
        call_ms=call_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        ordered_bound_ms=max(t_ordered, t_bytes),
        library_ms=None, pairs=stats["pairs"],
        kernel_pairs=errs["kernel_pairs"], S=S, bytes=nbytes,
        site_rel_err=errs["rel_f"], cell_rel_err_e=errs["rel_e"],
        rel_e_total=errs["rel_tot"], work=work)
    say(f"[time] direct_force: kernel {ms:.4f} ms (device; {call_ms:.4f} ms "
        f"per eager call), plain {plain_ms:.3f} ms, bound "
        f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}; "
        f"{stats['pairs'] // 2} unordered pairs x "
        f"{K2_PAIR_OPS + K2_REACTION_OPS} FP32 ops, {nbytes} bytes; the "
        f"{stats['pairs']} ordered pairs x {K2_PAIR_OPS} it evaluates "
        f"{entry['ordered_bound_ms']:.5f} ms)")
    say(f"[work] direct_force: {k2_work_line(work)}")
    return entry


def k2_grid(seed, box, rc, density, torch, np, dev="cuda"):
    """(plan, direct, center, ghost) of random sites at `density` per A^3
    in `box`, binned at a rebuild and then moved by K2_GRID_MOVE A (rms per
    axis) with their images fixed at the rebuild, so that some lie outside
    [0, box) in their cells; LJ and charges drawn per site, the first
    K2_GRID_COUPLED sites coupled."""
    import types

    from molchanica_tpu_torch.ops.direct_force import (DirectForce,
                                                       image_shift,
                                                       make_rebuild_fn,
                                                       plan_window)

    rng = np.random.default_rng(seed)
    box = np.asarray(box, np.float32)
    n = int(density * np.prod(box))
    x0 = (rng.uniform(0, 1, (n, 3)) * box).astype(np.float32)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    top = types.SimpleNamespace(
        charges=f32(rng.normal(0, 0.4, n)),
        lj_sigma=f32(rng.uniform(2.8, 3.4, n)),
        lj_eps=f32(rng.uniform(0.05, 0.2, n)),
        couple_mask=f32(np.arange(n) < K2_GRID_COUPLED),
        atom_mask=f32(np.ones(n)))
    plan = plan_window(box, rc, n, n, x0=x0)
    xt, bt = f32(x0), f32(box)
    sa, _, ovf = make_rebuild_fn(plan, top.atom_mask)(xt, bt)
    if int(ovf):
        raise SystemExit(f"K2 grid seed {seed}: overflow at the rebuild")
    x1 = xt + f32(rng.normal(0, K2_GRID_MOVE, (n, 3)))
    direct = DirectForce(top, plan)
    center, ghost = direct.inputs(x1, bt, sa, image_shift(xt, bt))
    return plan, direct, center, ghost


def k2_grid_phase(torch, np, dev="cuda"):
    """Phase 23: K2 against its plain version on K2_GRIDS (a capacity-128
    grid and an nc = 3 grid), with k2_check's gates and the kernel's time
    (graph_ms). Returns a summary per grid."""
    from molchanica_tpu_torch.ops.direct_force import direct_force_cuda
    from molchanica_tpu_torch.ops.pme import ewald_beta_for

    out = []
    for tag, seed, box, rc, density in K2_GRIDS:
        plan, direct, center, ghost = k2_grid(seed, box, rc, density, torch,
                                              np, dev)
        if tag == "C=128" and plan.capacity != 128 \
                or tag == "nc=3" and min(plan.nc) != 3:
            raise SystemExit(f"K2 grid {tag}: plan {plan}")
        couple = torch.tensor(K2_GRID_COUPLE, device=dev)
        beta = torch.tensor(ewald_beta_for(rc, 1e-5), device=dev)
        xs = center[center[:, 7] > 0.5, :3]
        outside = int(((xs < 0) | (xs >= torch.tensor(box, device=dev)))
                      .any(1).sum())
        errs, stats, _ = k2_check(f"direct_force {tag}", plan, direct,
                                  center, ghost, couple, beta, torch)
        ms = graph_ms(lambda: direct_force_cuda(plan, center, ghost, couple,
                                                beta), 20)
        say(f"[k2-grid] {tag}: {outside} sites outside [0, box) in their "
            f"cells; kernel {ms:.4f} ms (device)")
        out.append(dict(tag=tag, nc=plan.nc, capacity=plan.capacity,
                        pairs=stats["pairs"], outside=outside, ms=ms,
                        **errs))
    return out


def md_path(md, calls, torch, np, tag="md"):
    """The MdSim path: md.step(0.002, n) for each n in calls, K2 launches
    counted over exactly those calls; the last call timed."""
    from molchanica_tpu_torch.ops.direct_force import DirectForce

    dt = 0.002
    k = md.cfg.neighbor_rebuild_every
    DirectForce.launches = 0
    evals0 = md.force_evals
    for n in calls[:-1]:
        t0 = time.perf_counter()
        md.step(dt, n)
        torch.cuda.synchronize()
        say(f"[{tag}] warm-up {n} steps in {time.perf_counter() - t0:.1f} s")
    n = calls[-1]
    t0 = time.perf_counter()
    md.step(dt, n)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = DirectForce.launches
    n_eval = md.force_evals - evals0
    # a call of more than steps_per_chunk steps runs as calls of at most
    # steps_per_chunk, each n + ceil(n/k) + 1 force evaluations
    spc = md.cfg.steps_per_chunk
    pieces = [min(spc, c - d) for c in calls for d in range(0, c, spc)]
    expected = sum(p + -(-p // k) + 1 for p in pieces)
    ms_step = elapsed / n * 1e3
    ns_day = n * dt / 1000.0 / elapsed * 86400.0
    t_final = md.temperature()
    x = md.state.positions
    finite = bool(torch.isfinite(x).all())
    ovf = int(md._rebuild(x, md.state.box)[2])
    say(f"[{tag}] n={n} ms/step={ms_step:.4f} ns/day={ns_day:.3f} "
        f"T={t_final:.2f} K E_pot(last)={float(md.state.pe_last):.3f} "
        f"kcal/mol finite={finite} overflow={ovf} C={md._plan.capacity}")
    say(f"[{tag}] direct_force launches {launches}, force_evals {n_eval}, "
        f"expected {expected} (n + ceil(n/{k}) + 1 over the calls "
        f"{pieces} that steps {calls} make)")
    if not finite or not 100.0 < t_final < 600.0:
        raise SystemExit(f"unstable MdSim run: finite={finite} T={t_final}")
    if not launches == n_eval == expected:
        raise SystemExit(f"direct_force launches {launches} / force_evals "
                         f"{n_eval} != {expected}")
    return dict(ms_per_step=ms_step, ns_per_day=ns_day,
                temperature_K=t_final, elapsed_s=elapsed, n_timed=n,
                launches=launches)


def md_engine_parity(build_md, torch):
    """MdSim.force_fn on the card against the same MdSim on the CPU, on the
    CPU engine's initial state. Per site the limit is ENGINE_TOL_F of
    max|F| plus ENGINE_TOL_DIRECT of the site's direct-space scale; every
    energy term within rel 1e-5, for lj and coulomb of |ref| plus the
    kernel's |e| sums (MdSim.direct_space_scales): those hold the excluded
    solute pairs that are subtracted again."""
    t0 = time.perf_counter()
    md_g = build_md("cuda")
    md_c = build_md("cpu")
    x_c = md_c.state.positions
    sg, sc = md_g.state, md_c.state
    fg, (_, tg) = md_g.force_fn(x_c.to(md_g.device), sg.box, sg.couple)
    fc, (_, tc) = md_c.force_fn(x_c, sc.box, sc.couple)
    a, e_scale = md_c.direct_space_scales(x_c)
    err = (fg.cpu() - fc).abs().amax(dim=1)
    f_max = float(fc.abs().max())
    tol = ENGINE_TOL_F * f_max + ENGINE_TOL_DIRECT * a
    worst = int(torch.argmax(err / tol))
    worst_e, worst_k = 0.0, ""
    for k in ("bond", "angle", "dihedral", "recip", "lj", "coulomb"):
        ref = float(tc[k])
        rel = abs(float(tg[k]) - ref) / (abs(ref) + e_scale.get(k, 0.0))
        say(f"[md-engine] {k}: card {float(tg[k]):.6f} cpu {ref:.6f} "
            f"rel {rel:.2e}")
        if rel > worst_e:
            worst_e, worst_k = rel, k
    say(f"[md-engine] card vs CPU on the init state: max|dF|="
        f"{float(err.max()):.4f} (max|F|={f_max:.2f}); worst site {worst}: "
        f"|dF|={float(err[worst]):.4f} against limit "
        f"{float(tol[worst]):.4f} (direct scale {float(a[worst]):.4e}); "
        f"worst energy term {worst_k} rel {worst_e:.2e}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (bool((err <= tol).all()) and worst_e < 1e-5):
        raise SystemExit("MdSim engine parity failed")


def hydration_system(torch, np):
    """Phase 11: methanol as the coupled molecule in the reference
    protocol's 35 A OPC box, with run_sol_sim_fast's MdConfig; the card's
    FastSim on it (velocities from the engine's seeded generator)."""
    from molchanica_tpu_torch.md.alchemical import HYDRATION_BOX_SIDE
    from molchanica_tpu_torch.md.fast_engine import FastSim
    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.properties.water_sol import hydration_setup

    t0 = time.perf_counter()
    asys, cfg = hydration_setup(methanol(), HYDRATION_BOX_SIDE,
                                seed=TI_SEED)
    t1 = time.perf_counter()
    sim = FastSim(asys.topology, cfg, asys.positions,
                  box_extent=asys.box_extent, device="cuda")
    torch.cuda.synchronize()
    sp = sim._split
    say(f"[hyd] methanol in a {HYDRATION_BOX_SIDE:g} A OPC box: "
        f"{asys.topology.n_atoms_real} sites ({asys.n_waters} waters), "
        f"{sim.n_base} padded, built in {t1 - t0:.1f} s; FastSim init "
        f"{time.perf_counter() - t1:.1f} s: S={sim.S} S_L={sp['S_L']} "
        f"S_Q={sp['S_Q']} cols={sim.plan.nx}x{sim.plan.ny} "
        f"pme={tuple(sim._recip.K)} coupled={int(asys.topology.couple_mask.sum())} "
        f"intramol pairs={int(sim._im_mask.sum())} "
        f"E_pot(init)={float(sim.state.pe_last):.3f} kcal/mol")
    if not sim._has_alch:
        raise SystemExit("hydration system: no coupled atoms")
    return asys, cfg, sim


def ti_path(n_equil, n_prod, torch, np):
    """Phase 14: run_sol_sim_fast(methanol) on the card at the full box and
    lambda list; K1d launches counted over exactly that call. Returns
    (summary dict, launch counts)."""
    from molchanica_tpu_torch.md.alchemical import HYDRATION_LAMBDAS
    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.ops.colpair import ColpairDirect
    from molchanica_tpu_torch.properties import run_sol_sim_fast

    ColpairDirect.launches.clear()
    t0 = time.perf_counter()
    props = run_sol_sim_fast(methanol(), equil_steps=n_equil,
                             prod_steps=n_prod,
                             dhdl_interval=TI_DHDL_INTERVAL, seed=TI_SEED,
                             device="cuda")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(ColpairDirect.launches)
    rm = props.run_metrics
    n_eval = rm["force_evals"]
    n_samples = -(-n_prod // TI_DHDL_INTERVAL)
    n_win = len(HYDRATION_LAMBDAS)
    # init 1, minimize(300) 300 + 15, warm-up 400, window steps, 2 per dhdl
    expected = 1 + 315 + 400 + n_win * (n_equil + n_prod + 2 * n_samples)
    ms_step = rm["window_step_s"] / rm["window_steps"] * 1e3
    for w in props.windows:
        say(f"[ti] lambda={w.lam:.2f} <dH/dl>={w.mean:10.4f} kcal/mol "
            f"samples={np.array2string(w.dhdl_samples, precision=3)}")
    say(f"[ti] dG_hydration={props.dg_hydration_kcal:.4f} kcal/mol "
        f"SEM={props.dg_sem_kcal:.4f} (not converged: {n_prod} production "
        f"steps per window) contacts={props.mean_n_water_contacts:.2f} "
        f"h_bonds={props.mean_n_h_bonds:.2f} "
        f"coupled <dH/dl>={props.mean_coupled_interaction_kcal:.4f}")
    say(f"[ti] {n_win} windows x ({n_equil} + {n_prod}) steps: "
        f"{ms_step:.4f} ms/step over {rm['window_steps']} window steps; "
        f"T={rm['temperature_K']:.2f} K after the last window; the call "
        f"took {elapsed:.1f} s")
    total = sum(counts.values())
    say(f"[ti] colpair launches {total} (expected 2 x {n_eval} force "
        f"evaluations; {expected} evaluations without replans): {counts}")
    bad = [w.lam for w in props.windows
           if len(w.dhdl_samples) != n_samples
           or not np.isfinite(w.dhdl_samples).all()
           or not abs(w.mean) < DHDL_BLOWUP]
    if bad or len(props.windows) != n_win:
        raise SystemExit(f"TI path: windows {bad} lack {n_samples} finite "
                         f"samples or exceed |<dH/dl>| < {DHDL_BLOWUP:g}")
    if not np.isfinite(props.dg_hydration_kcal):
        raise SystemExit("TI path: non-finite dG")
    if not 100.0 < rm["temperature_K"] < 600.0:
        raise SystemExit(f"TI path: T={rm['temperature_K']} K")
    alch = [k for k in counts if "_alch_" in k]
    if total != 2 * n_eval or len(alch) != len(counts) or n_eval < expected:
        raise SystemExit(f"TI path: launches {counts} != 2 x {n_eval}")
    return dict(ms_per_step=ms_step, elapsed_s=elapsed,
                temperature_K=rm["temperature_K"],
                dg_hydration_kcal=props.dg_hydration_kcal,
                dg_sem_kcal=props.dg_sem_kcal, force_evals=n_eval,
                windows=[dict(lam=w.lam, samples=w.dhdl_samples.tolist())
                         for w in props.windows]), counts


def range_path(build0, n_warm, n_steps, torch, np, tag="range"):
    """Phase 15 (and 18's symmetric twin): FastSim(per_slice_k=0) on
    config 3. Its range instances against their plain versions, then
    step(0.002, n_warm), a timed step(0.002, n_steps) and
    potential_energy(), launches counted over exactly those calls.
    Returns (kernel entries, summary)."""
    from molchanica_tpu_torch.ops.colpair import ColpairDirect

    t0 = time.perf_counter()
    sim = build0()
    torch.cuda.synchronize()
    inst = engine_instances(sim, torch)
    w_max = sim.plan.w_max
    say(f"[{tag}] FastSim(per_slice_k=0) init "
        f"{time.perf_counter() - t0:.1f} s: psk={sim._psk} tables "
        + ", ".join(f"{k.name} {tuple(wl.shape)} max entries "
                    f"{int(nw.max())}" for k, _, wl, nw in inst)
        + f" (w_max {w_max})")
    if sim._psk != 0 or any(wl.shape[1] != 3 * w_max
                            for _, _, wl, _ in inst):
        raise SystemExit("FastSim(per_slice_k=0) did not build range tables")
    entries = kernel_parity(sim, torch)
    ColpairDirect.launches.clear()
    evals0 = sim.force_evals
    t0 = time.perf_counter()
    sim.step(0.002, n_warm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.step(0.002, n_steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    e_pot = sim.potential_energy()
    counts = dict(ColpairDirect.launches)
    n_eval = sim.force_evals - evals0
    t_final = sim.temperature()
    finite = bool(np.isfinite(sim.positions_unsorted()).all())
    ms_step = elapsed / n_steps * 1e3
    per_eval = len(inst) // 2          # kernels per force evaluation
    say(f"[{tag}] warm-up {n_warm} steps {t1 - t0:.1f} s; n={n_steps} "
        f"ms/step={ms_step:.4f} T={t_final:.2f} K E_pot={e_pot:.3f} "
        f"kcal/mol finite={finite} overflow={int(sim.state.overflow)}")
    say(f"[{tag}] colpair launches {sum(counts.values())} (expected "
        f"{per_eval} x {n_eval} force evaluations): {counts}")
    for e in entries:
        e["launches"] = counts.get(e["name"], 0)
    if not finite or not 100.0 < t_final < 600.0 or not np.isfinite(e_pot):
        raise SystemExit(f"range-table run: finite={finite} T={t_final}")
    if sum(counts.values()) != per_eval * n_eval or any(
            e["launches"] == 0 or "_range_" not in e["name"]
            for e in entries):
        raise SystemExit(f"range-table launches {counts} != {per_eval} x "
                         f"{n_eval}")
    return entries, dict(ms_per_step=ms_step, temperature_K=t_final,
                         n_timed=n_steps, force_evals=n_eval)


def shard_rank(rank, n_dev, device, plan, halo, rows, wl, nw, box, n_calls):
    """One rank of phase 16 (spawned by parallel/launch.py). For the energy
    and the force-only sharded colpair: the rank's K1f launch against its
    plain version on the rank's local inputs, both timed with CUDA events
    while the other ranks wait (the card's time is shared between the
    processes' contexts), then n_calls sharded calls on all ranks at once
    with the launches counted (host clock, exchange included), the
    exchange alone, and the gathered results."""
    import torch
    import torch.distributed as dist

    from molchanica_tpu_torch.ops.colpair import (ColpairDirect, colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain,
                                                  colpair_work)
    from molchanica_tpu_torch.parallel.spatial_colpair import (
        block, make_sharded_colpair_direct)

    to = lambda t: block(t, rank, n_dev).to(device).contiguous()
    rows_b, wl_b, nw_b = to(rows), to(wl), to(nw)
    box = box.to(device)
    couple = torch.ones((), device=device)
    out = dict(rank=rank, device=str(device))

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_calls * 1e3, r

    for we in (True, False):
        sh = make_sharded_colpair_direct(None, plan, halo, want_energy=we,
                                         device=device)
        kern = sh.kernel
        i_base = halo * sh.B
        pT, wl_loc = sh.local_inputs(rows_b, wl_b)
        n_k = torch.zeros(1, dtype=torch.int64, device=device)
        f_i, f_j, e = colpair_cuda(kern.cfg, rows_b, pT, wl_loc, nw_b, box,
                                   kern.params(device), couple, i_base=i_base,
                                   counts=n_k)
        stats = {}
        p_i, p_j, elj_p, ec_p = colpair_plain(rows_b, pT, wl_loc, nw_b, box,
                                              kern.cfg, couple, stats=stats,
                                              i_base=i_base)
        work = colpair_work(rows_b, pT, wl_loc, nw_b, box, kern.cfg,
                            i_base=i_base)
        torch.cuda.synchronize()

        def sites(a_i, a_j):
            """This rank's force on each local j slot: the own block's
            slots take their i-forces and their reactions together."""
            s = a_j.clone()
            s[i_base:i_base + a_i.shape[0]] += a_i
            return s

        n_i = rows_b.shape[0]
        f_k, f_p = sites(f_i, f_j), sites(p_i, p_j)
        stats["f_abs"] = sites(stats["f_abs"][:n_i], stats["f_abs"][n_i:])
        rel_f, rel_e = colpair_parity(f_k, e.sum(1), f_p, stats)
        err = float((f_k - f_p).abs().max())
        e_k, e_p = float(e.sum()), float(elj_p + ec_p)
        for r in range(n_dev):              # one rank on the card at a time
            dist.barrier()
            if r == rank:
                ms = graph_ms(lambda: colpair_cuda(
                    kern.cfg, rows_b, pT, wl_loc, nw_b, box,
                    kern.params(device), couple, i_base=i_base), 20)
                k_call_ms = cuda_ms(lambda: kern(rows_b, pT, wl_loc, nw_b,
                                                 box, couple), 20)
                plain_ms = cuda_ms(lambda: colpair_plain(
                    rows_b, pT, wl_loc, nw_b, box, kern.cfg, couple,
                    i_base=i_base), 3)
        e_cluster = sh.comm.all_gather(e.sum(1))
        # the main path: n_calls sharded calls, this rank's launches
        dist.barrier()
        ColpairDirect.launches.clear()
        call_ms, (f, e_lj, e_c) = host_ms(
            lambda: sh(rows_b, wl_b, nw_b, box, couple))
        launches = ColpairDirect.launches.get(kern.name, 0)
        dist.barrier()
        in_ms, _ = host_ms(lambda: sh.local_inputs(rows_b, wl_b))
        red_ms, _ = host_ms(lambda: sh.reduce(f_i, f_j, e.sum(0)))
        f_all = sh.comm.all_gather(f)
        nbytes = (rows_b.numel() + pT.numel() + wl_loc.numel() + nw_b.numel()
                  + 3 + 64 + f_i.numel() + f_j.numel() + e.numel()) * 4
        out[we] = dict(
            name=kern.name, pairs=stats["pairs"], kernel_pairs=int(n_k),
            pairs_near_rc=stats["pairs_near_rc"],
            work=work_counts(work),
            err=err,
            f_max=float(f_p.abs().max()), e_kernel=e_k, e_plain=e_p,
            rel_f=rel_f, rel_e=rel_e, ms=ms, kernel_call_ms=k_call_ms,
            plain_ms=plain_ms,
            call_ms=call_ms, exchange_in_ms=in_ms, reduce_ms=red_ms,
            launches=launches, calls=n_calls, nbytes=nbytes,
            s_local=sh.s_local, e_lj=float(e_lj), e_c=float(e_c),
            e_cluster=e_cluster.cpu(), f=f_all.cpu() if rank == 0 else None,
            backend=sh.comm.backend, world=sh.comm.size)
    return out


def shard_phase(asys, d, n_calls, torch, np):
    """Phase 16: the sharded colpair on config 3 over N_SHARD ranks on the
    one card (gloo). Returns (kernel entries, summary)."""
    from molchanica_tpu_torch.ops.colpair import (ColpairDirect,
                                                  colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain)
    from molchanica_tpu_torch.parallel.dryrun import sorted_colpair_state
    from molchanica_tpu_torch.parallel.launch import run_ranks
    from molchanica_tpu_torch.parallel.spatial_colpair import halo_depth_for

    top = asys.topology
    t0 = time.perf_counter()
    plan, rows, wl, nw, boxt = sorted_colpair_state(
        np.asarray(d["x"], np.float64),
        (top.charges * top.atom_mask).numpy().astype(np.float64),
        top.lj_sigma.numpy().astype(np.float64),
        top.lj_eps.numpy().astype(np.float64),
        np.asarray(asys.box_extent, np.float64), 9.0, N_SHARD,
        device="cuda")
    halo = halo_depth_for(plan, N_SHARD, wl.cpu(), nw.cpu())
    B = plan.n_sorted // N_SHARD
    say(f"[shard] {top.n_atoms} sites per-site sorted, rc 9 A, skin 0.5: "
        f"S={plan.n_sorted} NC={plan.n_clusters} cols={plan.nx}x{plan.ny} "
        f"w_max={plan.w_max} max entries {int(nw.max())}; {N_SHARD} blocks "
        f"of {B} slots, halo depth {halo} (local j array "
        f"{(2 * halo + 1) * B} slots); built in "
        f"{time.perf_counter() - t0:.1f} s")
    refs = {}
    pT = rows.T.contiguous()
    for we in (True, False):
        one = ColpairDirect(plan, we, range_tables=True)
        n_k = torch.zeros(1, dtype=torch.int64, device=rows.device)
        f1, e1 = colpair_cuda(one.cfg, rows, pT, wl, nw, boxt,
                              one.params(rows.device), counts=n_k)
        stats = {}
        f_p, elj_p, ec_p = colpair_plain(rows, pT, wl, nw, boxt, one.cfg,
                                         stats=stats)
        torch.cuda.synchronize()
        pair_count_check(f"{one.name} (one device)", int(n_k), stats)
        rel_f, rel_e = colpair_parity(f1, e1.sum(1), f_p, stats)
        err = float((f1 - f_p).abs().max()) / float(f_p.abs().max())
        ms = graph_ms(lambda: colpair_cuda(one.cfg, rows, pT, wl, nw, boxt,
                                           one.params(rows.device)), 20)
        say(f"[shard] one device {one.name}: vs plain max|dF|/max|F|="
            f"{err:.3e}, per site {rel_f:.3e}, per cluster {rel_e:.3e}; "
            f"kernel {ms:.4f} ms on all {plan.n_clusters} clusters "
            f"({stats['pairs']} pairs)")
        if not (err < KERNEL_TOL_F_MAX and rel_f < KERNEL_TOL_F
                and rel_e < KERNEL_TOL_E):
            raise SystemExit(f"{one.name}: kernel and plain disagree")
        refs[we] = (f1.cpu(), e1.cpu(), {k: (v.cpu() if torch.is_tensor(v)
                                             else v)
                                         for k, v in stats.items()})
    t0 = time.perf_counter()
    res = run_ranks(shard_rank, N_SHARD, "gloo", "cuda",
                    (plan, halo, rows.cpu(), wl.cpu(), nw.cpu(), boxt.cpu(),
                     n_calls))
    wall = time.perf_counter() - t0
    r0 = res[0][True]
    say(f"[shard] {r0['world']} ranks over {r0['backend']} on "
        f"{sorted({r['device'] for r in res})}: spawn, checks and "
        f"{2 * n_calls} sharded calls per rank in {wall:.1f} s")
    entries, summary = [], {}
    for we in (True, False):
        rk = [r[we] for r in res]
        name = rk[0]["name"]
        for r, x in zip(res, rk):
            rel_tot = abs(x["e_kernel"] - x["e_plain"]) / max(
                abs(x["e_plain"]), 1e-30)
            say(f"[shard] rank {r['rank']} {name}: pairs={x['pairs']} "
                f"max|dF|/max|F|={x['err'] / x['f_max']:.3e} per site "
                f"{x['rel_f']:.3e} per cluster {x['rel_e']:.3e} rel_e "
                f"{rel_tot:.3e}; kernel {x['ms']:.4f} ms (device; "
                f"{x['kernel_call_ms']:.4f} ms per eager call), plain "
                f"{x['plain_ms']:.3f} ms; sharded call {x['call_ms']:.3f} "
                f"ms (exchange in {x['exchange_in_ms']:.3f}, reduce "
                f"{x['reduce_ms']:.3f}); launches {x['launches']} of "
                f"{x['calls']} calls")
            if not (x["err"] / x["f_max"] < KERNEL_TOL_F_MAX
                    and x["rel_f"] < KERNEL_TOL_F
                    and x["rel_e"] < KERNEL_TOL_E
                    and (not we or rel_tot < KERNEL_TOL_E_TOT)):
                raise SystemExit(f"{name} rank {r['rank']}: kernel and "
                                 "plain disagree")
            if x["launches"] != x["calls"]:
                raise SystemExit(f"{name} rank {r['rank']}: {x['launches']}"
                                 f" launches in {x['calls']} calls")
            pair_count_check(f"{name} rank {r['rank']}", x["kernel_pairs"],
                             x)
            say(f"[work] {name} rank {r['rank']}: "
                + work_line(x["work"], torch.cuda.get_device_properties(0)
                            .multi_processor_count))
        f1, e1, stats = refs[we]
        f_sh = rk[0]["f"]
        err = float((f_sh - f1).abs().max()) / float(f1.abs().max())
        rel_f, rel_e = colpair_parity(f_sh, rk[0]["e_cluster"], f1,
                                      dict(stats, e_cluster=e1.sum(1)))
        de = [abs(rk[0][k] - float(e1[:, i].sum())) / max(
            abs(float(e1[:, i].sum())), 1.0)
            for i, k in enumerate(("e_lj", "e_c"))]
        say(f"[shard] {name} assembled over {N_SHARD} ranks vs one device: "
            f"max|dF|/max|F|={err:.3e} (limit {SHARD_TOL_F_MAX:g}), per "
            f"site {rel_f:.3e}, per cluster {rel_e:.3e}; e_lj "
            f"{rk[0]['e_lj']:.4f} vs {float(e1[:, 0].sum()):.4f}, e_c "
            f"{rk[0]['e_c']:.4f} vs {float(e1[:, 1].sum()):.4f} (rel "
            f"{max(de):.3e})")
        if not (err < SHARD_TOL_F_MAX and rel_f < KERNEL_TOL_F
                and rel_e < KERNEL_TOL_E and max(de) < KERNEL_TOL_E_TOT):
            raise SystemExit(f"{name}: sharded and one device disagree")
        mean = lambda k: float(np.mean([x[k] for x in rk]))
        # the bound of the mean rank's work, as ms is the mean rank's time
        t_ops = mean("pairs") * PAIR_OPS[("full", we)] / PEAK_FP32 * 1e3
        t_bytes = mean("nbytes") / PEAK_BYTES * 1e3
        entries.append(dict(
            name=name, route="cuda",
            source="molchanica_tpu_torch/csrc/colpair.cu",
            replaces=K1_REPLACES,
            launches=sum(x["launches"] for x in rk),
            max_abs_err=max(x["err"] for x in rk), ms=mean("ms"),
            plain_ms=mean("plain_ms"),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, ranks=N_SHARD, halo=halo,
            per_rank=[{k: x[k] for k in ("pairs", "kernel_pairs", "ms",
                                         "plain_ms", "call_ms",
                                         "exchange_in_ms", "reduce_ms",
                                         "launches", "rel_f", "rel_e",
                                         "work")} for x in rk],
            assembled_rel_err=err))
        summary[name] = dict(call_ms=mean("call_ms"),
                             exchange_in_ms=mean("exchange_in_ms"),
                             reduce_ms=mean("reduce_ms"), kernel_ms=mean("ms"))
        say(f"[time] {name}: kernel {mean('ms'):.4f} ms per rank (mean of "
            f"{N_SHARD}, each alone on the card), plain "
            f"{mean('plain_ms'):.3f} ms, bound {entries[-1]['bound_ms']:.5f}"
            f" ms ({entries[-1]['bound_by']}); sharded call "
            f"{mean('call_ms'):.3f} ms, exchange in "
            f"{mean('exchange_in_ms'):.3f} ms, reduce "
            f"{mean('reduce_ms'):.3f} ms")
    return entries, dict(summary, halo=halo, S=plan.n_sorted, ranks=N_SHARD,
                         backend=r0["backend"], wall_s=wall)


def rigid_water_error(sim, np) -> float:
    """max |d(O-H) - r_OH| over the waters of the engine's current state."""
    top = sim.top
    if not top.water_count:
        return 0.0
    x = sim.positions_unsorted()
    ws, wc, st = top.water_start, top.water_count, top.water_site_count
    o = x[ws:ws + wc * st:st]
    return max(float(np.abs(np.linalg.norm(x[ws + k:ws + wc * st:st] - o,
                                           axis=1) - top.water_r_oh).max())
               for k in (1, 2))


def sym_vs_tri(sim, entries, torch):
    """Phase 18: on one fresh master sort of the symmetric engine's state,
    each symmetric instance on the symmetric table against the monolithic
    triangular instance on the triangular table (the comparison
    scripts/check_triangular.py makes): forces within SYM_TOL_F_MAX of
    max|F| and, per site, SYM_TOL_F of the symmetric plain run's pair
    magnitudes; total energies rel KERNEL_TOL_E_TOT; and the float64 plain
    sums of the two tables per site within SYM_TOL_F64 (the same pairs),
    the symmetric table holding each of the triangular table's pairs twice
    (to SYM_PAIRS_SLACK).
    For the force-only instance, two faulted runs of the symmetric kernel
    (sym_fault_ratios) must fail the per-site gate. Adds the triangular
    table's pairs and bound to the symmetric entries."""
    from molchanica_tpu_torch.ops.colpair import (ICL, ColpairDirect,
                                                  colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain,
                                                  make_window_fn)

    st = sim.state
    dev = st.x.device
    _, keys, _, _, xs, props = sim._sort(st)
    rows = torch.cat([xs, props], 1)
    pT = rows.T.contiguous()
    for we, entry in zip((False, True), entries):
        res = {}
        for tri in (False, True):
            wl, nw, ovf = make_window_fn(sim.plan, per_slice_k=sim._psk,
                                         triangular=tri)(xs, keys, st.box,
                                                         props[:, 4])
            if int(ovf):
                raise SystemExit(f"sym vs tri: table overflow {int(ovf)}")
            kern = ColpairDirect(sim.plan, we, triangular=tri)
            f, e = colpair_cuda(kern.cfg, rows, pT, wl, nw, st.box,
                                kern.params(dev))
            stats = {}
            colpair_plain(rows, pT, wl, nw, st.box, kern.cfg, stats=stats)
            r64 = rows.double()
            f64 = colpair_plain(r64, r64.T.contiguous(), wl, nw,
                                st.box.double(), kern.cfg)[0]
            res[tri] = (f, e, stats, kern, f64, wl, nw)
        (fs, es, ss, ks, fs64, wl_s, nw_s), (ft, et, stt, kt, ft64, _, _) = \
            res[False], res[True]
        torch.cuda.synchronize()
        err = float((fs - ft).abs().max()) / float(ft.abs().max())
        rel_f, _ = colpair_parity(fs, es.sum(1), ft, ss)
        scale = ss["f_abs"].double().clamp_min(1e-30)
        site_rel = lambda a, b: float(((a.double() - b).abs().amax(dim=1)
                                       / scale).max())
        rel_64 = site_rel(fs64, ft64)
        rel_s64, rel_t64 = site_rel(fs, fs64), site_rel(ft, ft64)
        worst = int(((fs - ft).abs().amax(dim=1) / scale).argmax())
        xw = rows[worst, :3]
        face = float(torch.minimum(xw, st.box - xw).min())
        e_s, e_t = float(es.sum()), float(et.sum())
        rel_e = abs(e_s - e_t) / max(abs(e_t), 1e-30)
        t_tri = max(stt["pairs"] * pair_ops(kt.cfg) / PEAK_FP32 * 1e3,
                    entry["bytes"] / PEAK_BYTES * 1e3)
        entry.update(tri_pairs=stt["pairs"], tri_bound_ms=t_tri)
        say(f"[sym] {ks.name} vs triangular {kt.name} on one state: "
            f"max|dF|/max|F|={err:.3e} (limit {SYM_TOL_F_MAX:g}), per site "
            f"{rel_f:.3e} (limit {SYM_TOL_F:g}); float64 plain sums per "
            f"site {rel_64:.3e} (limit {SYM_TOL_F64:g}); each kernel against"
            f" its table's float64 sum per site: symmetric {rel_s64:.3e}, "
            f"triangular {rel_t64:.3e}; energy {e_s:.4f} vs {e_t:.4f} rel "
            f"{rel_e:.3e}; ordered pairs {ss['pairs']} vs unordered "
            f"{stt['pairs']}; bound {entry['bound_ms']:.5f} vs "
            f"{t_tri:.5f} ms; worst site {worst} (group id "
            f"{float(rows[worst, 7]):.0f}) {face:.3f} A from a box face")
        entry.update(tri_site_rel_err=rel_f, tri_f64_site_rel_err=rel_64,
                     f64_site_rel_err=rel_s64)
        if not (err < SYM_TOL_F_MAX and rel_f < SYM_TOL_F
                and rel_64 < SYM_TOL_F64
                and abs(ss["pairs"] - 2 * stt["pairs"]) <= SYM_PAIRS_SLACK
                * ss["pairs"]
                and (not we or rel_e < KERNEL_TOL_E_TOT)):
            raise SystemExit(f"{ks.name}: symmetric and triangular disagree")
        if not we:
            faults = sym_fault_ratios(sim, rows, wl_s, nw_s, ks, ft, ss,
                                      worst // ICL, torch)
            say("[sym] faults of the symmetric kernel against the triangular"
                " one, per site: " + "; ".join(
                    f"{k} {v:.3e}" for k, v in faults.items())
                + f" (each must exceed {SYM_TOL_F:g})")
            entry.update(fault_site_rel_err=faults)
            if not all(v > SYM_TOL_F for v in faults.values()):
                raise SystemExit("the symmetric-vs-triangular gate missed a "
                                 "fault")


def sym_fault_ratios(sim, rows, wl, nw, kern, f_ref, stats, c, torch):
    """The per-site ratio (colpair_parity against f_ref, on `stats`) of the
    symmetric kernel run with a known fault on its table's inputs: the
    entries over i-cluster c's own slots emptied, and water O's LJ well
    depth off by 1e-3."""
    from molchanica_tpu_torch.ops.colpair import (ICL, colpair_cuda,
                                                  colpair_parity)

    st = sim.state
    dev = rows.device
    wl_f = wl.clone()
    e = wl_f.view(wl.shape[0], -1, 3)[c]
    own = ((torch.arange(e.shape[0], device=dev) < nw[c])
           & (e[:, 0] < (c + 1) * ICL) & (e[:, 1] > c * ICL))
    e[own, 1] = e[own, 0]
    g = rows[:, 7]
    o_w = ((g >= sim._ws + 1) & (g < sim._ws + sim._n_wsites + 1)
           & (rows[:, 5] > 0))
    rows_f = rows.clone()
    rows_f[:, 5] = torch.where(o_w, rows[:, 5] * (1.0 + 1e-3) ** 0.5,
                               rows[:, 5])
    out = {}
    for name, r, w in ((f"cluster {c}'s own-slot entries emptied", rows,
                        wl_f), ("water O well depth x 1.001", rows_f, wl)):
        f = colpair_cuda(kern.cfg, r, r.T.contiguous(), w, nw, st.box,
                         kern.params(dev))[0]
        out[name] = colpair_parity(f, stats["e_cluster"], f_ref, stats)[0]
    return out


def sym_engine_parity(build_sym, build_split, torch):
    """Phase 18: the symmetric engine's whole force (force-only and energy
    functions) and energy terms against the default split engine, both on
    the card at the same state: per site within ENGINE_TOL_F of max|F| plus
    SYM_TOL_F of the site's direct-space scale (the symmetric plain run's
    f_abs, spread like the force; see SYM_TOL_F), terms rel 1e-5. Prints
    where the difference comes from: each engine's direct-space force
    against the float64 plain sum of the symmetric table (the same pairs
    as the split tables), and the rest of the two forces, per site in
    units of that scale."""
    from molchanica_tpu_torch.ops.colpair import colpair_plain

    t0 = time.perf_counter()
    sym, spl = build_sym(), build_split()
    if not torch.equal(sym.state.perm, spl.state.perm):
        raise SystemExit("sym engine parity: the two sorts differ")
    st = sym.state
    st_s = spl.state.replace(x=st.x)
    with torch.no_grad():
        (kern, rows, wl, nw) = engine_instances(sym, torch)[0]
        stats = {}
        colpair_plain(rows, rows.T.contiguous(), wl, nw, st.box, kern.cfg,
                      stats=stats)
        a = sym._spread_vsite_forces(stats["f_abs"][:, None].repeat(1, 3),
                                     st)[:, 0]
        a64 = a.double().clamp_min(1e-30)
        r64 = rows.double()
        live = st.props[:, 4:5] > 0
        spread = lambda f: sym._spread_vsite_forces(f, st) * live
        site = lambda f: f.abs().amax(dim=1) / a64
        for we in (False, True):
            fs, (_, ts) = sym._make_force_fn(we)(st.x, st)
            fp, (_, tp) = spl._make_force_fn(we)(st_s.x, st_s)
            err = (fs - fp).abs().amax(dim=1)
            f_max = float(fp.abs().max())
            tol = ENGINE_TOL_F * f_max + SYM_TOL_F * a
            worst = int(torch.argmax(err / tol))
            f64 = colpair_plain(r64, r64.T.contiguous(), wl, nw,
                                st.box.double(), sym._direct[we].cfg)[0]
            d_s, d_p = (spread(e._direct_force(e._apply_vsites(
                s.x, s, s.box), s, we)[0].double() - f64)
                for e, s in ((sym, st), (spl, st_s)))
            rest = (fs - fp).double() - (d_s - d_p)
            q_s, q_p, q_r = site(d_s), site(d_p), site(rest)
            say(f"[sym-engine] {'energy' if we else 'force-only'}: per site "
                f"(units of the direct-space scale) at the worst site "
                f"{worst}: engines {float(site(fs - fp)[worst]):.3e}, at "
                f"most the sum of: symmetric direct vs float64 "
                f"{float(q_s[worst]):.3e}, split direct vs float64 "
                f"{float(q_p[worst]):.3e}, the rest "
                f"{float(q_r[worst]):.3e}; over all sites: symmetric "
                f"{float(q_s.max()):.3e}, split {float(q_p.max()):.3e}, rest "
                f"{float(q_r.max()):.3e}")
            terms = ("bond", "angle", "dihedral", "recip") + (
                ("lj", "coulomb") if we else ())
            worst_e = max(abs(float(ts[k]) - float(tp[k]))
                          / max(abs(float(tp[k])), 1e-30) for k in terms)
            say(f"[sym-engine] {'energy' if we else 'force-only'}: symmetric "
                f"vs split engine on one state: max|dF|="
                f"{float(err.max()):.4f} (max|F|={f_max:.2f}); worst site "
                f"{worst}: |dF|={float(err[worst]):.4f} against limit "
                f"{float(tol[worst]):.4f}; worst energy term rel "
                f"{worst_e:.2e}" + (f"; lj {float(ts['lj']):.3f} vs "
                                    f"{float(tp['lj']):.3f}, coulomb "
                                    f"{float(ts['coulomb']):.3f} vs "
                                    f"{float(tp['coulomb']):.3f}"
                                    if we else ""))
            if not (bool((err <= tol).all()) and worst_e < 1e-5):
                raise SystemExit("symmetric vs split engine parity failed")
    say(f"[sym-engine] two engines and checks "
        f"{time.perf_counter() - t0:.1f} s")


def sym_path(build_sym, build_split, n_warm, n_steps, torch, np):
    """Phase 18: FastSim(triangular=False) on config 3. A warm-up step call
    (a per-slice overflow of the symmetric tables replans there), its two
    instances against their plain versions on the state's tables, the
    symmetric against the triangular kernel and the symmetric against the
    split engine on one state, then the main path: a timed
    run(0.002, n_steps, n_steps // 2) with its two snapshots, launches
    counted over exactly that call. Returns (kernel entries, summary)."""
    from molchanica_tpu_torch.ops.colpair import ColpairDirect

    t0 = time.perf_counter()
    sim = build_sym(None)
    torch.cuda.synchronize()
    st = sim.state
    say(f"[sym] FastSim(triangular=False) init {time.perf_counter() - t0:.1f}"
        f" s: S={sim.S} NC={sim.plan.n_clusters} psk={sim._psk} "
        f"split={sim._split is not None} wl {tuple(st.wl.shape)} max "
        f"entries {int(st.nw.max())} overflow={int(st.overflow)} "
        f"(triangular knob {sim._tri})")
    if sim._split is not None or sim._tri:
        raise SystemExit("FastSim(triangular=False) did not build the "
                         "symmetric engine")
    t0 = time.perf_counter()
    sim.step(0.002, n_warm)
    torch.cuda.synchronize()
    say(f"[sym] warm-up {n_warm} steps in {time.perf_counter() - t0:.1f} s: "
        f"psk={sim._psk} max entries {int(sim.state.nw.max())} "
        f"force_evals={sim.force_evals}")
    entries = kernel_parity(sim, torch)
    sym_vs_tri(sim, entries, torch)
    sym_engine_parity(lambda: build_sym(sim._psk), build_split, torch)
    ColpairDirect.launches.clear()
    evals0 = sim.force_evals
    t0 = time.perf_counter()
    snaps = sim.run(0.002, n_steps, max(n_steps // 2, 1))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(ColpairDirect.launches)
    n_eval = sim.force_evals - evals0
    t_final = sim.temperature()
    finite = bool(np.isfinite(sim.positions_unsorted()).all())
    ms_step = elapsed / n_steps * 1e3
    e_snap = [s.energy_data.energy_potential for s in snaps[-2:]]
    say(f"[sym] run(0.002, {n_steps}, {max(n_steps // 2, 1)}): "
        f"ms/step={ms_step:.4f} (two snapshot energy evaluations included) "
        f"T={t_final:.2f} K finite={finite} psk={sim._psk} "
        f"overflow={int(sim.state.overflow)}; snapshots at "
        f"{[round(s.time, 6) for s in snaps]} ps, E_pot {e_snap} kcal/mol")
    say(f"[sym] colpair launches {sum(counts.values())} (expected 1 x "
        f"{n_eval} force evaluations, replans included): {counts}")
    for e in entries:
        e["launches"] = counts.get(e["name"], 0)
    if not finite or not 100.0 < t_final < 600.0 \
            or not np.isfinite(e_snap).all() or len(snaps) != 2:
        raise SystemExit(f"symmetric run: finite={finite} T={t_final} "
                         f"snapshots={len(snaps)}")
    if sum(counts.values()) != n_eval or any(e["launches"] == 0
                                             for e in entries):
        raise SystemExit(f"symmetric launches {counts} != {n_eval}")
    return entries, dict(ms_per_step=ms_step, temperature_K=t_final,
                         n_timed=n_steps, force_evals=n_eval,
                         psk=sim._psk, elapsed_s=elapsed), sim


def sym_alch_path(build_hs, n_steps, torch, np):
    """Phase 19: FastSim(triangular=False) on the hydration system at
    couple 0.5: its two has_alch symmetric instances against their plain
    versions on the master table, then step(0.002, n_steps) and one dhdl,
    launches counted over exactly those calls. Returns the entries."""
    from molchanica_tpu_torch.ops.colpair import ColpairDirect

    t0 = time.perf_counter()
    sim = build_hs()
    sim.configure_alchemical_window(1.0 - ALCH_COUPLES[0])
    torch.cuda.synchronize()
    say(f"[sym-alch] FastSim(triangular=False) on the hydration system "
        f"init {time.perf_counter() - t0:.1f} s: S={sim.S} psk={sim._psk} "
        f"max entries {int(sim.state.nw.max())} "
        f"overflow={int(sim.state.overflow)}")
    entries = kernel_parity(sim, torch)
    if any("_alch_sym_" not in e["name"] for e in entries):
        raise SystemExit("hydration symmetric engine: no has_alch instances")
    ColpairDirect.launches.clear()
    evals0 = sim.force_evals
    sim.step(0.002, n_steps)
    d = sim.dhdl()
    torch.cuda.synchronize()
    counts = dict(ColpairDirect.launches)
    n_eval = sim.force_evals - evals0
    t = sim.temperature()
    say(f"[sym-alch] {n_steps} steps and one dhdl at lambda "
        f"{1.0 - ALCH_COUPLES[0]:g}: dH/dl={d:.4f} kcal/mol T={t:.2f} K; "
        f"colpair launches {sum(counts.values())} (expected {n_eval} force "
        f"evaluations): {counts}")
    for e in entries:
        e["launches"] = counts.get(e["name"], 0)
    if not np.isfinite(d) or not np.isfinite(sim.positions_unsorted()).all():
        raise SystemExit("symmetric hydration run: non-finite result")
    if sum(counts.values()) != n_eval or any(e["launches"] == 0
                                             for e in entries):
        raise SystemExit(f"symmetric has_alch launches {counts} != {n_eval}")
    return entries


def cross_phase(sim, n_calls, torch, np):
    """Phase 20: K1g on config 3. The i side is the solute (every non-water
    site), per-site sorted on the master's column grid; the j side is the
    master array of `sim`'s current state. Cross windows, the kernel
    against its plain version, the assembled f_i + f_j and energies against
    the plain triangular kernel over the master table restricted to pairs
    with a solute site (all pairs minus the water-water ones), then
    n_calls driven calls with the launches counted. Returns the entries."""
    import dataclasses

    from molchanica_tpu_torch.ops.colpair import (ICL, ColpairDirect,
                                                  colpair_plain,
                                                  make_sort_fn,
                                                  make_window_fn)

    st = sim.state
    dev = st.x.device
    perm_m, keys_m, _, _, xs, props = sim._sort(st)
    rows_m = torch.cat([xs, props], 1)
    pT = rows_m.T.contiguous()
    S_j = rows_m.shape[0]
    n_base = sim.n_base
    xb = torch.zeros((n_base + 1, 3), device=dev)
    xb[perm_m] = xs
    sol = torch.nonzero((~sim._in_w_base)
                        & (sim._props_base[:n_base, 4] > 0))[:, 0]
    n_sol = int(sol.numel())
    cap = n_sol + ICL * sim.plan.n_cols
    plan_sub = dataclasses.replace(sim.plan, n_sorted=-(-cap // 128) * 128,
                                   n_base=n_sol)
    perm_s, keys_s, _, ovf = make_sort_fn(plan_sub)(
        xb[sol], st.box, torch.ones(n_sol, device=dev))
    if int(ovf):
        raise SystemExit("cross: subset sort overflow")
    pad = lambda a: torch.cat([a, torch.zeros_like(a[:1])])
    xs_s = torch.cat([xb[sol], torch.full((1, 3), 1.0e6, device=dev)])[perm_s]
    rows_s = torch.cat([xs_s, pad(sim._props_base[sol])[perm_s]], 1)
    wlo, whi = float(sim._ws + 1), float(sim._ws + sim._n_wsites + 1)
    psk = sim._psk
    while True:
        wl, nw, ovf = make_window_fn(plan_sub, per_slice_k=psk,
                                     cross_j_size=S_j)(
            rows_s[:, :3], keys_s, st.box, rows_s[:, 7], keys_m,
            rows_m[:, 7])
        if not int(ovf):
            break
        psk *= 2
    say(f"[cross] solute subset {n_sol} sites: S_i={plan_sub.n_sorted} "
        f"NC={plan_sub.n_clusters} against the master S_j={S_j}; per-slice "
        f"table K={psk}, max entries {int(nw.max())}; water gid range "
        f"[{wlo:g}, {whi:g})")
    # master slot of each real subset slot, for the assembly
    inv = torch.full((n_base + 1,), S_j, dtype=torch.int64, device=dev)
    inv[perm_m] = torch.arange(S_j, device=dev)
    real_s = perm_s < n_sol
    slot_m = inv[sol[perm_s[real_s]]]
    wl_t, nw_t, _ = make_window_fn(sim.plan, per_slice_k=sim._psk)(
        xs, keys_m, st.box, props[:, 4])
    g = rows_m[:, 7]
    rows_w = rows_m.clone()
    solute_m = (g > 0) & ((g < wlo) | (g >= whi))
    rows_w[:, 3] = torch.where(solute_m, 0.0, rows_w[:, 3])
    rows_w[:, 5] = torch.where(solute_m, 0.0, rows_w[:, 5])
    entries = []
    for we in (False, True):
        kern = ColpairDirect(plan_sub, we, cross=(wlo, whi, S_j))
        entry = instance_parity(kern, rows_s, pT, wl, nw, st.box, torch)
        f_i, f_j, e_lj, e_c = kern(rows_s, pT, wl, nw, st.box, None)
        f = f_j.clone()
        f.index_add_(0, slot_m, f_i[real_s])
        tri = ColpairDirect(sim.plan, we).cfg
        f_all, lj_all, c_all = colpair_plain(rows_m, pT, wl_t, nw_t, st.box,
                                             tri)
        f_ww, lj_ww, c_ww = colpair_plain(rows_w, rows_w.T.contiguous(),
                                          wl_t, nw_t, st.box, tri)
        ref = f_all - f_ww
        e_ref = float(lj_all + c_all - lj_ww - c_ww)
        torch.cuda.synchronize()
        err = float((f - ref).abs().max()) / float(ref.abs().max())
        e_k = float(e_lj + e_c)
        rel_e = abs(e_k - e_ref) / max(abs(e_ref), 1e-30)
        say(f"[cross] {kern.name}: f_i + f_j assembled vs the plain "
            f"triangular kernel over pairs with a solute site: max|dF|/"
            f"max|F|={err:.3e} (limit {SYM_TOL_F_MAX:g}); energy {e_k:.4f} vs "
            f"{e_ref:.4f} rel {rel_e:.3e}")
        if not (err < SYM_TOL_F_MAX and (not we or rel_e < KERNEL_TOL_E_TOT)):
            raise SystemExit(f"{kern.name}: cross and triangular disagree")
        ColpairDirect.launches.clear()
        for _ in range(n_calls):
            kern(rows_s, pT, wl, nw, st.box, None)
        torch.cuda.synchronize()
        entry.update(launches=ColpairDirect.launches.get(kern.name, 0),
                     assembled_rel_err=err)
        if entry["launches"] != n_calls:
            raise SystemExit(f"{kern.name}: {entry['launches']} launches in "
                             f"{n_calls} calls")
        entries.append(entry)
    return entries


def probe_bytes(nw, sl, S) -> int:
    """Bytes the probe's function must move on these inputs: nw, the sl
    entries it reads, column 0 of the rows of every cluster with an entry,
    row 0 of pT over each slice the entries name once, and o and o2 written
    whole."""
    import numpy as np

    NC, W = sl.shape
    n = np.clip(nw, 0, W)
    s = sl[np.arange(W)[None, :] < n[:, None]]
    s = np.unique(s[(s >= 0) & (s < S // 128)])
    return 4 * (NC + int(n.sum()) + int((n > 0).sum()) * 64 + s.size * 128
                + NC * 64 * 8 + 8 * S)


def probe_phase(torch, np, dev="cuda"):
    """Phase 21: P. At the script's shapes and at PROBE_BIG, the kernel
    against probe_plain and the script's loop (rel < 1e-6), timed by
    graph_ms with the eager time beside it; then
    the main path: the module's main() on the card, launches counted over
    exactly that call. Returns the JSON entry (script shapes; the large
    shape's numbers under *_big)."""
    from molchanica_tpu_torch.ops import probe_prefetch as P

    entry = dict(name="probe_prefetch", route="cuda",
                 source="molchanica_tpu_torch/csrc/probe_prefetch.cu",
                 replaces=PROBE_REPLACES, library_ms=None)
    for sfx, (NC, W, S) in (("", (16, 8, None)), ("_big", PROBE_BIG)):
        arrs = P.probe_inputs(NC, W, S)
        nw, sl, rows, pT = (torch.as_tensor(a, device=dev) for a in arrs)
        o, o2 = P.probe_cuda(nw, sl, rows, pT)
        op, o2p = P.probe_plain(nw, sl, rows, pT)
        torch.cuda.synchronize()
        e_plain = P.rel_errors(o.cpu().numpy(), o2.cpu().numpy(),
                               op.cpu().numpy(), o2p.cpu().numpy())
        e_loop = P.rel_errors(o.cpu().numpy(), o2.cpu().numpy(),
                              *P.probe_loop(*arrs))
        err = float(max((o - op).abs().max(), (o2 - o2p).abs().max()))
        launch = lambda: P.probe_cuda(nw, sl, rows, pT)
        ms, call_ms = graph_ms(launch, 50), cuda_ms(launch, 50)
        plain_ms = cuda_ms(lambda: P.probe_plain(nw, sl, rows, pT), 5)
        pairs = int(np.minimum(np.clip(arrs[0], 0, W), W).sum()) * 64 * 128
        nbytes = probe_bytes(*arrs[:2], pT.shape[1])
        t_ops = pairs * PROBE_PAIR_OPS / PEAK_FP32 * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        S = pT.shape[1]
        say(f"[probe] NC={NC} W={W} S={S}: rel err vs plain o={e_plain[0]:.2e}"
            f" o2={e_plain[1]:.2e}, vs loop o={e_loop[0]:.2e} "
            f"o2={e_loop[1]:.2e} (limit 1e-6); kernel {ms:.4f} ms (device; "
            f"{call_ms:.4f} ms per eager call), plain "
            f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.6f} ms "
            f"({pairs} pairs, {nbytes} bytes)")
        if max(*e_plain, *e_loop) >= 1e-6:
            raise SystemExit(f"probe NC={NC} S={S}: kernel and plain disagree")
        entry.update({f"max_abs_err{sfx}": err, f"ms{sfx}": ms,
                      f"call_ms{sfx}": call_ms, f"plain_ms{sfx}": plain_ms,
                      f"bound_ms{sfx}": max(t_ops, t_bytes),
                      f"bound_by{sfx}": ("operations" if t_ops >= t_bytes
                                         else "bytes"),
                      f"S{sfx}": S, f"pairs{sfx}": pairs})
    P.launches = 0
    rc = P.main([])
    entry["launches"] = P.launches
    if rc != 0 or P.launches != 1:
        raise SystemExit(f"probe main(): exit {rc}, {P.launches} launches")
    return entry


def npt_path(build_npt, n_steps, torch, np):
    """Phase 22: NPT on config 3, FastSim with the Berendsen barostat,
    run(0.002, n_steps, n_steps // 2); each period's pressure and box; the
    box must move, T stay in band, the state stay finite and the waters
    rigid, and colpair launches equal 2 x the force evaluations (two per
    barostat period and one per snapshot among them). Returns the
    summary."""
    from molchanica_tpu_torch.ops.colpair import ColpairDirect

    t0 = time.perf_counter()
    sim = build_npt()
    torch.cuda.synchronize()
    box0 = float(sim.state.box[0])
    say(f"[npt] FastSim with BarostatCfg(pressure_target="
        f"{sim.cfg.barostat_cfg.pressure_target:g}, tau="
        f"{sim.cfg.barostat_cfg.tau:g}) init {time.perf_counter() - t0:.1f} "
        f"s: box {box0:.4f} A")
    ColpairDirect.launches.clear()
    evals0 = sim.force_evals
    t0 = time.perf_counter()
    snaps = sim.run(0.002, n_steps, max(n_steps // 2, 1))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(ColpairDirect.launches)
    n_eval = sim.force_evals - evals0
    for step, p, bx in sim.pressure_log:
        say(f"[npt] step {step}: P={p:.2f} bar, box {bx:.6f} A")
    box = float(sim.state.box[0])
    t_final = sim.temperature()
    finite = bool(np.isfinite(sim.positions_unsorted()).all())
    rigid = rigid_water_error(sim, np)
    ms_step = elapsed / n_steps * 1e3
    say(f"[npt] run(0.002, {n_steps}, {max(n_steps // 2, 1)}): "
        f"ms/step={ms_step:.4f} (barostat and snapshot evaluations "
        f"included) T={t_final:.2f} K box {box0:.6f} -> {box:.6f} A "
        f"(ratio {box / box0:.8f}) finite={finite} max|d(O-H) - r_OH|="
        f"{rigid:.3e} A; {len(snaps)} snapshots")
    say(f"[npt] colpair launches {sum(counts.values())} (expected 2 x "
        f"{n_eval} force evaluations): {counts}")
    if not finite or not 100.0 < t_final < 600.0 or box == box0 \
            or rigid >= RIGID_TOL or len(snaps) != 2:
        raise SystemExit(f"NPT run: finite={finite} T={t_final} box "
                         f"{box0}->{box} rigid {rigid}")
    if sum(counts.values()) != 2 * n_eval or not sim.pressure_log:
        raise SystemExit(f"NPT launches {counts} != 2 x {n_eval}")
    return dict(ms_per_step=ms_step, temperature_K=t_final, box0=box0,
                box=box, n_timed=n_steps, force_evals=n_eval,
                pressures=[p for _, p, _ in sim.pressure_log],
                rigid_err=rigid, elapsed_s=elapsed)


def md_rigid_error(md, np) -> float:
    """max |d(O-H) - r_OH| over the waters of an MdSim's current state."""
    top = md.top
    if not top.water_count:
        return 0.0
    x = md.state.positions.cpu().numpy()
    ws, wc, st = top.water_start, top.water_count, top.water_site_count
    o = x[ws:ws + wc * st:st]
    return max(float(np.abs(np.linalg.norm(x[ws + k:ws + wc * st:st] - o,
                                           axis=1) - top.water_r_oh).max())
               for k in (1, 2))


def snapshot_temperatures(md, snaps, np):
    """Temperature (K) of each snapshot from its kinetic energy, with the
    degrees of freedom of MdSim.temperature."""
    from molchanica_tpu_torch.constants import KB

    d = md.top.dof_mask.cpu().numpy().astype(np.float64)
    ndof = max(3.0 * d.sum() - md.n_constraints - 3.0, 1.0)
    return [2.0 * s.kinetic_energy / (KB * ndof) for s in snaps]


def default_md_phase(asys, d, torch, np):
    """Phase A: MdSim as a user gets it on config 3: MdConfig's defaults
    (velocity-Verlet + CSVR at tau 0.1 ps, SHAKE, FIRE over 200
    iterations, use_pallas=False: the cluster-pair backend) at the 9 A
    cutoff and seed 7, from eq25k.npz's positions (velocities drawn at
    310 K). FIRE runs in the reference's block structure (two blocks of
    100 iterations when the first block's end passes E0 + max(1% |E0|,
    10 kcal/mol), else one loop of 200 from the start); the path, each
    block's end and the state kept are printed. A single FIRE loop climbs
    far above E0 on this state (the reference's FIRE climbs alike on the
    1,312-site test system:
    tests/test_torch_fire.py::test_fire_climbs_like_the_reference); where
    the path's end fails that bound the engine keeps the lowest state the
    path evaluated, so the energy after FIRE at most E0 + the margin
    holds by construction. What FIRE must show besides: its lowest
    evaluated energy lies at least that margin below E0, and the state
    kept has the energy FIRE gave it (the end one or the lowest) after the
    replan (rel 1e-5 of |E| plus the direct space's |e| sums, as phase B).
    The waters stay rigid."""
    from molchanica_tpu_torch.md.config import MdConfig
    from molchanica_tpu_torch.md.engine import MdSim

    cfg = MdConfig(lj_cutoff=9.0, coulomb_cutoff=9.0, seed=7)
    t0 = time.perf_counter()
    md = MdSim(asys.topology, cfg, d["x"], box_extent=asys.box_extent,
               device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = md.relax_log
    e_after = md.potential_energy()
    e0 = r["e_first"]
    rigid = md_rigid_error(md, np)
    plan = md._plan
    say(f"[mdd] MdSim(MdConfig(lj_cutoff=9, coulomb_cutoff=9, seed=7)) "
        f"init {wall:.1f} s, of which FIRE {r['seconds']:.1f} s over "
        f"{r['iters']} iterations ({1e3 * r['seconds'] / r['iters']:.2f} "
        f"ms each, a cluster rebuild and a force per iteration); backend "
        f"{md._nbr_backend}: NC={plan.n_clusters} M={plan.m_neighbors} "
        f"fine cells {plan.fine_cells}; integrator "
        f"{md.cfg.integrator.kind} tau={md.cfg.integrator.thermostat_tau} "
        f"constraints={md.n_constraints} pme={md._recip.grid}")
    say(f"[mdd] FIRE path {r['path']} (blocks of {r['block']}; the "
        f"first block's end against E0 + max(1% |E0|, 10) chooses it), "
        f"block ends {[round(e, 3) for e in r['block_ends']]}")
    say(f"[mdd] FIRE: E {e0:.3f} at the start, {r['e_end']:.3f} at the "
        f"end, lowest evaluated {r['e_lowest']:.3f}; kept the {r['kept']} "
        f"state (the end one unless it fails E0 + max(1% |E0|, 10)): E "
        f"{e_after:.3f} kcal/mol after the replan; max|d(O-H) - r_OH|="
        f"{rigid:.3e} A; T after init {md.temperature():.2f} K")
    if md._nbr_backend != "clusters":
        raise SystemExit(f"MdSim default backend {md._nbr_backend}")
    margin = max(0.01 * abs(e0), 10.0)
    e_kept = r["e_lowest"] if r["kept"] == "lowest" else r["e_end"]
    with torch.no_grad():
        _, e_scale = md.direct_space_scales(md.state.positions)
    kept_tol = 1e-5 * (abs(e_kept) + sum(e_scale.values()))
    say(f"[mdd] FIRE's lowest {r['e_lowest']:.3f} lies "
        f"{e0 - r['e_lowest']:.3f} below E0 (at least {margin:.3f} asked); "
        f"kept {r['kept']}: {e_kept:.3f}, after the replan {e_after:.3f} "
        f"(limit {kept_tol:.3f})")
    if not (np.isfinite(e_after) and e_after <= e0 + margin):
        raise SystemExit(f"FIRE raised the energy: {e0} -> {e_after}")
    if not r["e_lowest"] <= e0 - margin:
        raise SystemExit(f"FIRE found no state {margin} below E0: "
                         f"{e0} -> lowest {r['e_lowest']}")
    if not abs(e_after - e_kept) <= kept_tol:
        raise SystemExit(f"the kept state's energy moved: {e_kept} -> "
                         f"{e_after}")
    if rigid >= RIGID_TOL:
        raise SystemExit(f"waters not rigid after FIRE: {rigid}")
    return md, dict(init_s=wall, fire_s=r["seconds"], fire_iters=r["iters"],
                    fire_path=r["path"], block_ends=r["block_ends"],
                    e_first=e0, e_end=r["e_end"], e_lowest=r["e_lowest"],
                    kept=r["kept"], e_after=e_after, rigid_err=rigid,
                    n_clusters=plan.n_clusters, m=plan.m_neighbors)


def cluster_phase(md, torch, np):
    """Phase B on phase A's state: every pair of real sites within rc (by a
    blocked brute-force search on the card) lies in the [NC, M] list; the
    cluster force on the card against the same function on the CPU, and
    against the window backend on the card (per site ENGINE_TOL_F of
    max|F| plus ENGINE_TOL_DIRECT of the site's pair-term magnitudes,
    energies rel 1e-5 of |E| plus their |e| sums); device ms of a rebuild
    and of each backend's force evaluation."""
    from molchanica_tpu_torch.md.energy import apply_virtual_sites
    from molchanica_tpu_torch.ops.cells import make_xla_direct_force_fn
    from molchanica_tpu_torch.ops.clusters import (
        CL, make_cluster_direct_force_fn)

    t0 = time.perf_counter()
    s = md.state
    top, plan = md.top, md._plan
    box, couple, beta = s.box, s.couple, md._beta
    with torch.no_grad():
        xv = apply_virtual_sites(s.positions, top)
        order, nbr, ovf = md._rebuild(xv, box)
        counts = (nbr >= 0).sum(1)
        n, ncl = plan.n_atoms, plan.n_clusters
        slot = torch.empty_like(order)
        slot[order] = torch.arange(n, device=order.device)
        cl_of = slot // CL
        adj = torch.zeros((ncl, ncl), dtype=torch.bool, device=nbr.device)
        rows = torch.arange(ncl, device=nbr.device)[:, None].expand_as(nbr)
        ok = nbr >= 0
        adj[rows[ok], nbr[ok]] = True
        real = torch.nonzero(top.atom_mask > 0)[:, 0]
        xr = xv[real]
        rc2 = float(plan.cutoff) ** 2
        n_pairs = missing = 0
        for i0 in range(0, real.numel(), 1024):
            dd = xr[i0:i0 + 1024, None, :] - xr[None, :, :]
            dd = dd - box * torch.round(dd / box)
            r2 = (dd * dd).sum(-1)
            ii, jj = torch.nonzero(r2 < rc2, as_tuple=True)
            keep = ii + i0 != jj
            ii, jj = ii[keep] + i0, jj[keep]
            n_pairs += int(ii.numel())
            missing += int((~adj[cl_of[real[ii]], cl_of[real[jj]]]).sum())
    say(f"[clusters] list on A's state: {n_pairs} ordered pairs of real "
        f"sites within rc = {plan.cutoff:g} A, {missing} missing from the "
        f"[{ncl}, {plan.m_neighbors}] list; row counts max "
        f"{int(counts.max())} / M = {plan.m_neighbors}, mean "
        f"{float(counts.float().mean()):.1f}; overflow {int(ovf)}")
    if missing or int(ovf) or n_pairs == 0:
        raise SystemExit(f"cluster list misses {missing} pairs "
                         f"(overflow {int(ovf)})")

    with torch.no_grad():
        f_g, elj_g, ec_g, _ = md._direct(xv, box, couple, beta, order, nbr)
        top_c = top.to("cpu")
        direct_c = make_cluster_direct_force_fn(top_c, md.cfg, plan)
        stats = {}
        f_c, elj_c, ec_c, _ = direct_c(
            xv.cpu(), box.cpu(), couple.cpu(), beta.cpu(), order.cpu(),
            nbr.cpu(), stats=stats)
        a = stats["f_abs"]
        win = make_xla_direct_force_fn(top, md.cfg, md._box_np,
                                       x0=xv.cpu().numpy())
        f_w, elj_w, ec_w, ovf_w = win(xv, box, couple, beta)
    f_max = float(f_c.abs().max())
    tol = ENGINE_TOL_F * f_max + ENGINE_TOL_DIRECT * a
    e_scale = (stats["e_abs_lj"], stats["e_abs_c"])
    res = {}
    for tag, f, el, ec in (("card vs CPU", f_g.cpu(), elj_g, ec_g),
                           ("window vs clusters", f_w.cpu(), elj_w, ec_w)):
        ref = f_c if tag == "card vs CPU" else f_g.cpu()
        rl, rc = ((elj_c, ec_c) if tag == "card vs CPU" else (elj_g, ec_g))
        err = (f - ref).abs().amax(dim=1)
        worst = int(torch.argmax(err / tol))
        e_rel = max(abs(float(el) - float(rl)) / (abs(float(rl)) + e_scale[0]),
                    abs(float(ec) - float(rc)) / (abs(float(rc)) + e_scale[1]))
        say(f"[clusters] {tag}: max|dF|={float(err.max()):.4f} (max|F|="
            f"{f_max:.2f}); worst site {worst}: |dF|={float(err[worst]):.4f}"
            f" against limit {float(tol[worst]):.4f}; e_lj {float(el):.4f} "
            f"vs {float(rl):.4f}, e_c {float(ec):.4f} vs {float(rc):.4f}, "
            f"rel (of |E| + |e| sums) {e_rel:.2e}")
        if not (bool((err <= tol).all()) and e_rel < 1e-5):
            raise SystemExit(f"cluster force parity ({tag}) failed")
        res[tag] = dict(max_df=float(err.max()), e_rel=e_rel)
    if int(ovf_w):
        raise SystemExit(f"window binning overflow {int(ovf_w)}")

    with torch.no_grad():
        t_rebuild = graph_ms(lambda: md._rebuild(xv, box), 5)
        t_clus = graph_ms(lambda: md._direct(xv, box, couple, beta, order,
                                             nbr), 10)
        t_win = graph_ms(lambda: win(xv, box, couple, beta), 5)
        e_rebuild = cuda_ms(lambda: md._rebuild(xv, box), 5)
        e_clus = cuda_ms(lambda: md._direct(xv, box, couple, beta, order,
                                            nbr), 10)
        e_win = cuda_ms(lambda: win(xv, box, couple, beta), 5)
        e_force = cuda_ms(lambda: md.force_fn(s.positions, box, couple), 10)
    nc_w, cap_w, shifts_w = win.plan
    say(f"[clusters] device ms (CUDA graph; eager per call in brackets): "
        f"rebuild {t_rebuild:.4f} [{e_rebuild:.4f}], cluster force "
        f"{t_clus:.4f} [{e_clus:.4f}] over {ncl * plan.m_neighbors * 64} "
        f"pair slots, window force {t_win:.4f} [{e_win:.4f}] over "
        f"{int(np.prod(nc_w)) * cap_w * cap_w * len(shifts_w)} pair slots "
        f"(nc={nc_w}, C={cap_w}, {len(shifts_w)} shifts); MdSim.force_fn "
        f"(rebuild + clusters + pme_rest) eager {e_force:.4f}; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(pairs=n_pairs, max_count=int(counts.max()),
                m=plan.m_neighbors, rebuild_ms=t_rebuild,
                cluster_ms=t_clus, window_ms=t_win,
                rebuild_eager_ms=e_rebuild, cluster_eager_ms=e_clus,
                window_eager_ms=e_win, force_fn_eager_ms=e_force, **res)


def default_md_path(md, n_warm, n_steps, torch, np):
    """Phase C: phase A's MdSim, step(0.002, n_warm), then a timed
    run(0.002, n_steps, n_steps // 2) with its two snapshots; finite, 100 K
    < T < 600 K, and the mean of the snapshots' and the final temperature
    within 10% of 310 K (CSVR)."""
    dt = 0.002
    t0 = time.perf_counter()
    md.step(dt, n_warm)
    torch.cuda.synchronize()
    say(f"[mdd] warm-up {n_warm} steps in {time.perf_counter() - t0:.1f} s")
    evals0 = md.force_evals
    t0 = time.perf_counter()
    snaps = md.run(dt, n_steps, max(n_steps // 2, 1))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_eval = md.force_evals - evals0
    temps = snapshot_temperatures(md, snaps, np) + [md.temperature()]
    t_mean = float(np.mean(temps))
    finite = bool(torch.isfinite(md.state.positions).all())
    ms_step = elapsed / n_steps * 1e3
    ns_day = n_steps * dt / 1000.0 / elapsed * 86400.0
    say(f"[mdd] run(0.002, {n_steps}, {max(n_steps // 2, 1)}): ms/step="
        f"{ms_step:.4f} ns/day={ns_day:.3f} (snapshots included) "
        f"force_evals {n_eval}; T at the snapshots and the end "
        f"{', '.join(f'{t:.2f}' for t in temps)} K (mean {t_mean:.2f}); "
        f"E_pot {snaps[-1].energy_data.energy_potential:.3f} kcal/mol; "
        f"finite={finite}; {len(snaps)} snapshots")
    if not finite or not all(100.0 < t < 600.0 for t in temps) \
            or abs(t_mean - 310.0) > 31.0 or len(snaps) != 2:
        raise SystemExit(f"MdSim default run: finite={finite} T={temps}")
    return dict(ms_per_step=ms_step, ns_per_day=ns_day, force_evals=n_eval,
                temperatures_K=temps, elapsed_s=elapsed, n_timed=n_steps)


def default_npt_path(md, n_steps, torch, np):
    """Phase D: NPT on the cluster path, BarostatCfg(1 bar, tau NPT_TAU),
    from phase C's state: run(0.002, n_steps, n_steps // 2); each block's
    pressure (autograd of the cluster energy), the peak device memory of
    one pressure evaluation, the box moved, finite, T in band, waters
    rigid."""
    from molchanica_tpu_torch.md.barostat import scaling_pressure_bar
    from molchanica_tpu_torch.md.config import BarostatCfg
    from molchanica_tpu_torch.md.energy import apply_virtual_sites
    from molchanica_tpu_torch.md.engine import MdSim

    cfg = md.cfg.replace(barostat_cfg=BarostatCfg(1.0, tau=NPT_TAU))
    s = md.state
    t0 = time.perf_counter()
    npt = MdSim(md.top, cfg, s.positions.cpu().numpy(),
                box_extent=s.box.cpu().numpy(),
                velocities=s.velocities.cpu().numpy(), relax=False,
                device="cuda")
    torch.cuda.synchronize()
    box0 = float(npt.state.box[0])
    st = npt.state
    top = npt.top
    with torch.no_grad():
        nbr, _ = npt._rebuild_nbr(apply_virtual_sites(st.positions, top),
                                  st.box)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    p0 = float(scaling_pressure_bar(
        lambda a, b, c: npt._energy_nbr(a, b, c, nbr), st.positions, st.box,
        st.velocities, top.masses, top.dof_mask, st.couple,
        mol_id=top.mol_id, n_mol=top.n_mol))
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t1
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    say(f"[mdd-npt] MdSim NPT init {t1 - t0:.1f} s; one pressure by "
        f"autograd of the cluster + pme_rest energy: P={p0:.2f} bar in "
        f"{p_s * 1e3:.1f} ms, peak device memory {peak_gb:.3f} GiB above "
        f"the {base / 2 ** 30:.3f} GiB held")
    t0 = time.perf_counter()
    snaps = npt.run(0.002, n_steps, max(n_steps // 2, 1))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    for step, p, bx in npt.pressure_log:
        say(f"[mdd-npt] step {step}: P={p:.2f} bar, box {bx:.6f} A")
    box = float(npt.state.box[0])
    t_final = npt.temperature()
    finite = bool(torch.isfinite(npt.state.positions).all())
    rigid = md_rigid_error(npt, np)
    ms_step = elapsed / n_steps * 1e3
    say(f"[mdd-npt] run(0.002, {n_steps}, {max(n_steps // 2, 1)}): "
        f"ms/step={ms_step:.4f} T={t_final:.2f} K box {box0:.6f} -> "
        f"{box:.6f} A finite={finite} max|d(O-H) - r_OH|={rigid:.3e} A")
    if not finite or not 100.0 < t_final < 600.0 or box == box0 \
            or rigid >= RIGID_TOL or len(snaps) != 2:
        raise SystemExit(f"MdSim NPT: finite={finite} T={t_final} box "
                         f"{box0}->{box} rigid {rigid}")
    return dict(ms_per_step=ms_step, temperature_K=t_final, box0=box0,
                box=box, pressures=[p for _, p, _ in npt.pressure_log],
                pressure_peak_gib=peak_gb, pressure_ms=p_s * 1e3,
                rigid_err=rigid, elapsed_s=elapsed, n_timed=n_steps)


def vacuum_phase(n_steps, torch, np):
    """Phase E: the verify recipe: ethanol in vacuum (allpairs) with
    Langevin-middle (gamma 2), flexible H and FIRE at construction;
    compute_energy_snapshot with each MdOverrides ablation zeroing its own
    terms; the force on the card against the CPU's at build_ethanol's
    geometry (1e-4 of max|F|), and at the relaxed state against the CPU's
    float64 force (1e-4 of max|F| plus VAC_FLOORS x the CPU's float32
    error); the energy at both (rel 1e-5); run(0.001, n_steps,
    n_steps // 4)."""
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig,
                                                MdOverrides)
    from molchanica_tpu_torch.md.engine import MdSim, compute_energy_snapshot
    from molchanica_tpu_torch.systems.testmols import build_ethanol

    top, x0 = build_ethanol()
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=2.0),
                   hydrogen_constraint=HydrogenConstraint.flexible(), seed=7)
    t0 = time.perf_counter()
    sim = MdSim(top, cfg, x0, device="cuda")
    torch.cuda.synchronize()
    r = sim.relax_log
    say(f"[vac] ethanol MdSim init {time.perf_counter() - t0:.2f} s: "
        f"method {sim.method}, FIRE {r['iters']} iterations in "
        f"{r['seconds']:.2f} s, E {r['e_first']:.4f} -> {r['e_last']:.4f}")
    if sim.method != "allpairs" or not r["e_last"] < r["e_first"]:
        raise SystemExit(f"vacuum MdSim: {sim.method} {r}")
    x = sim.state.positions
    base = compute_energy_snapshot(top, cfg, x, device="cuda")
    say("[vac] terms: " + ", ".join(f"{k} {v:.5f}" for k, v in base.items()))
    owned = {"bonded_disabled": ("bond", "angle", "dihedral"),
             "coulomb_disabled": ("coulomb",), "lj_disabled": ("lj",),
             "long_range_recip_disabled": ("recip",)}
    for ab, keys in owned.items():
        t = compute_energy_snapshot(
            top, cfg.replace(overrides=MdOverrides(**{ab: True})), x,
            device="cuda")
        others = [k for k in ("bond", "angle", "dihedral", "lj", "coulomb")
                  if k not in keys]
        bad = [k for k in keys if t[k] != 0.0] + [
            k for k in others if abs(t[k] - base[k]) > 1e-6 * abs(base[k])]
        say(f"[vac] {ab}: " + ", ".join(f"{k} {t[k]:.5f}" for k in keys))
        if bad:
            raise SystemExit(f"ablation {ab} touched {bad}")
    if not all(np.isfinite(v) and v != 0.0 for k, v in base.items()
               if k in ("bond", "angle", "dihedral", "lj", "coulomb")):
        raise SystemExit(f"vacuum terms: {base}")
    cpu = MdSim(top, cfg, x.cpu().numpy(), relax=False, device="cpu")
    cpu64 = MdSim(top, cfg.replace(dtype="float64"),
                  x.cpu().numpy().astype(np.float64), relax=False,
                  device="cpu")
    # at the relaxed state |F| ~ 3e-3 kcal/mol/A is the sum of bonded and
    # pair forces of ~1 whose float32 roundoff (the bonds' stiffness times
    # the coordinates' roundoff) is ~3e-5: there the card's float32 force
    # is held to the float64 force on the CPU within 1e-4 of max|F| plus
    # VAC_FLOORS x the CPU's own float32 error against it
    for tag, xx in (("start", torch.as_tensor(x0)), ("relaxed", x.cpu())):
        with torch.no_grad():
            f_g, (e_g, _) = sim.force_fn(xx.to(sim.device), None,
                                         sim.state.couple)
            f_c, (e_c, _) = cpu.force_fn(xx, None, cpu.state.couple)
        err = float((f_g.cpu() - f_c).abs().max())
        f_max = float(f_c.abs().max())
        e_rel = abs(float(e_g) - float(e_c)) / abs(float(e_c))
        say(f"[vac] {tag}: force card vs CPU max|dF|={err:.3e} (max|F|="
            f"{f_max:.3f}); energy {float(e_g):.6f} vs {float(e_c):.6f} "
            f"rel {e_rel:.2e}")
        if (tag == "start" and err > 1e-4 * f_max) or e_rel > 1e-5:
            raise SystemExit("vacuum force parity failed")
    with torch.no_grad():
        f_64, _ = cpu64.force_fn(x.cpu().double(), None, cpu64.state.couple)
    err64 = float((f_g.cpu().double() - f_64).abs().max())
    floor = float((f_c.double() - f_64).abs().max())
    lim = 1e-4 * float(f_64.abs().max()) + VAC_FLOORS * floor
    say(f"[vac] relaxed: card (float32) vs CPU float64 max|dF|={err64:.3e} "
        f"against {lim:.3e} (1e-4 of max|F| {float(f_64.abs().max()):.3e} "
        f"+ {VAC_FLOORS:g} x the CPU's float32 error {floor:.3e})")
    if not err64 <= lim:
        raise SystemExit("vacuum force parity at the relaxed state failed")
    t0 = time.perf_counter()
    snaps = sim.run(0.001, n_steps, max(n_steps // 4, 1))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    temps = snapshot_temperatures(sim, snaps, np)
    finite = bool(torch.isfinite(sim.state.positions).all())
    t_mean = float(np.mean(temps))
    say(f"[vac] run(0.001, {n_steps}, {max(n_steps // 4, 1)}): "
        f"{elapsed * 1e3 / n_steps:.4f} ms/step, {len(snaps)} snapshots, T "
        f"{', '.join(f'{t:.1f}' for t in temps)} K (mean {t_mean:.1f}), "
        f"last E_pot {snaps[-1].energy_data.energy_potential:.4f}, "
        f"finite={finite}")
    if not finite or len(snaps) != 4 or not 100.0 < t_mean < 600.0:
        raise SystemExit(f"vacuum run: finite={finite} T={temps}")
    return dict(ms_per_step=elapsed * 1e3 / n_steps, temperatures_K=temps,
                force_err=err, relaxed_err_f64=err64, f32_floor=floor,
                fire_s=r["seconds"])


def alch_md_phase(asys_h, cfg_h, x_rel, v_zero, n_steps, torch, np):
    """Phase F: MdSim on the hydration state of phase 13 (methanol coupled,
    cells_pme on the cluster backend) at couple 0.5: dhdl (finite
    difference, h = 1e-3) on the card against the CPU within DHDL_FLOORS
    of its float32 floor eps32 (sum|terms| + the direct |e| sums) / 2h,
    a diagnostic that resolves nothing finer than ~30 kcal/mol; the
    autograd -dE/dcouple of the same neighbour state, card against CPU,
    within ALCH_MD_AUTOGRAD_REL; then n_steps steps on the card, finite
    and 100 K < T < 600 K."""
    from molchanica_tpu_torch.md.energy import apply_virtual_sites
    from molchanica_tpu_torch.md.engine import MdSim

    def autograd_dhdl(sim):
        """-dE/dcouple by autograd of the differentiable energy of the
        same neighbour state: a diagnostic beside the float32 FD."""
        st = sim.state
        with torch.no_grad():
            nbr, _ = sim._rebuild_nbr(
                apply_virtual_sites(st.positions, sim.top), st.box)
        c = st.couple.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            e = sim._energy_nbr(st.positions, st.box, c, nbr)
            (g,) = torch.autograd.grad(e, c)
        return -float(g)

    cfg = cfg_h.replace(use_pallas=False, max_init_relaxation_iters=None)
    t0 = time.perf_counter()
    sims = {dev: MdSim(asys_h.topology, cfg, x_rel,
                       box_extent=asys_h.box_extent, velocities=v_zero,
                       device=dev) for dev in ("cuda", "cpu")}
    g, c = sims["cuda"], sims["cpu"]
    for sim in (g, c):
        sim.configure_alchemical_window(1.0 - ALCH_COUPLES[0])
    with torch.no_grad():
        st_g, st_c = g.state, c.state
        d_g = float(g.dhdl_fn(st_g.positions, st_g.box, st_g.couple))
        d_c = float(c.dhdl_fn(st_c.positions, st_c.box, st_c.couple))
        _, (_, terms) = c.force_fn(st_c.positions, st_c.box, st_c.couple)
        _, e_scale = c.direct_space_scales(st_c.positions)
    floor = float(np.finfo(np.float32).eps) * (
        sum(abs(float(terms[k])) for k in ("bond", "angle", "dihedral",
                                           "recip", "lj", "coulomb"))
        + sum(e_scale.values())) / (2.0 * DHDL_H)
    say(f"[alch-md] MdSim on the hydration state ({g.method}, backend "
        f"{g._nbr_backend}, {asys_h.topology.n_atoms_real} sites, "
        f"{int(asys_h.topology.couple_mask.sum())} coupled), couple "
        f"{ALCH_COUPLES[0]}: dhdl card {d_g:.4f} CPU {d_c:.4f} kcal/mol, "
        f"|diff| {abs(d_g - d_c):.4f} against {DHDL_FLOORS:g} x float32 "
        f"floor {floor:.4f}; {time.perf_counter() - t0:.1f} s")
    a_g, a_c = autograd_dhdl(g), autograd_dhdl(c)
    a_rel = abs(a_g - a_c) / abs(a_c)
    say(f"[alch-md] autograd -dE/dcouple: card {a_g:.6f} CPU {a_c:.6f} "
        f"kcal/mol, rel {a_rel:.2e} (limit {ALCH_MD_AUTOGRAD_REL:g})")
    if g._nbr_backend != "clusters" or not np.isfinite(d_g) \
            or abs(d_g - d_c) > DHDL_FLOORS * floor:
        raise SystemExit("MdSim alchemical dhdl parity failed")
    if not a_rel <= ALCH_MD_AUTOGRAD_REL:
        raise SystemExit("MdSim alchemical autograd dE/dcouple parity "
                         "failed")
    t0 = time.perf_counter()
    g.step(0.002, n_steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    finite = bool(torch.isfinite(g.state.positions).all())
    temp = g.temperature()
    say(f"[alch-md] {n_steps} steps: {ms:.2f} ms/step, dhdl "
        f"{float(g.state.dhdl_last):.4f}, T {temp:.2f} K, finite={finite}")
    # from zero velocities on a 20-iteration minimization of a freshly
    # built box: the strain turns into heat (FastSim reads ~440 K after
    # 20 steps from the same state, phase 19)
    if not finite or not np.isfinite(float(g.state.dhdl_last)) \
            or not 100.0 < temp < 600.0:
        raise SystemExit(f"MdSim alchemical steps: finite={finite} "
                         f"T={temp}")
    return dict(dhdl_card=d_g, dhdl_cpu=d_c, floor=floor,
                autograd_card=a_g, autograd_cpu=a_c, autograd_rel=a_rel,
                temperature_K=temp)


def nvt_hold(sim, n, np):
    """Mean temperature over n more steps, sampled every 200."""
    temps = []
    for _ in range(n // 200):
        sim.step(0.002, 200)
        temps.append(sim.temperature())
    mean = float(np.mean(temps))
    say(f"[hold] {n} steps: T mean {mean:.2f} K, min {min(temps):.2f}, "
        f"max {max(temps):.2f} (target 310 K)")
    if not abs(mean - 310.0) < 5.0:
        raise SystemExit(f"NVT hold off target: {mean} K")


def profile_calls(fn, torch):
    """Trace one call of fn(): (key_averages, their device-time key, the
    device-side events as (time, event), device ms, kernels, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side events only (the aten ops that launched them carry the
    # same time again)
    dev = [(getattr(e, key), e) for e in ka
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(t for t, _ in dev) / 1e3
    launches = sum(e.count for _, e in dev)
    return ka, key, dev, dev_ms, launches, wall_ms


def profile_kernels(fn, torch):
    """Trace one call of fn() with the CUDA activity alone: a dict of the
    kernels' device ms and count, the copies' and fills' (Memcpy, Memset)
    device ms and count, the wall ms, and the seconds the trace took to
    read. No CPU-side op is recorded, so a call of thousands of kernels
    reads quickly. A trace taken after earlier traces in the process can
    miss a call's first copies and kernels (PERF.md §5)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    out = dict(kernel_ms=0.0, kernels=0, copy_ms=0.0, copies=0,
               wall_ms=(t1 - t0) * 1e3)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = (("copy_ms", "copies")
                 if e.name.startswith(("Memcpy", "Memset"))
                 else ("kernel_ms", "kernels"))
        out[ms] += e.time_range.elapsed_us() / 1e3
        out[n] += 1
    out["read_s"] = time.perf_counter() - t1
    if not out["kernels"]:
        raise SystemExit("profile_kernels: the trace holds no kernel")
    return out


def profile_steps(sim, n, torch, out_dir, prefix=""):
    """Trace n steps: device busy share, kernel launches per step and the
    kernels by device time (full tables in out_dir/profile.txt if given)."""
    ka, key, dev, dev_ms, launches, wall_ms = profile_calls(
        lambda: sim.step(0.002, n), torch)
    say(f"[{prefix}profile] {n} steps: wall {wall_ms / n:.3f} ms/step, "
        f"device busy {dev_ms / n:.3f} ms/step "
        f"({100.0 * dev_ms / wall_ms:.1f}%), "
        f"{launches / n:.0f} kernels/step")
    for t, e in sorted(dev, key=lambda p: -p[0])[:15]:
        say(f"[{prefix}profile] {t / 1e3 / n:9.4f} ms/step "
            f"{e.count / n:7.1f}/step {e.key[:90]}")
    if out_dir:
        with open(os.path.join(out_dir, f"{prefix}profile.txt"), "w") as fh:
            fh.write(ka.table(sort_by=key, row_limit=80))
            fh.write("\n\n")
            fh.write(ka.table(sort_by="self_cpu_time_total", row_limit=80))


def farm_force_gate(f, f_ref, f_scale):
    """max over sites of |dF| / (ENGINE_TOL_F max|F_ref| + ENGINE_TOL_DIRECT
    x the site's direct-space scale): the card-vs-CPU engine gate."""
    err = (f - f_ref).abs().amax(dim=-1)
    tol = ENGINE_TOL_F * float(f_ref.abs().max()) \
        + ENGINE_TOL_DIRECT * f_scale
    return float((err / tol).max())


def farm_temperatures(farm, tag, np):
    """Per-replica T and finiteness of a farm, gated at 100 K < T < 600 K."""
    temps = farm.temperatures()
    finite = bool(np.isfinite(farm.x.detach().cpu().numpy()).all())
    say(f"[{tag}] T per replica {np.round(temps, 2).tolist()} K, "
        f"finite={finite}")
    if not finite or not ((temps > 100.0) & (temps < 600.0)).all():
        raise SystemExit(f"{tag}: finite={finite} T={temps.tolist()}")
    return temps


def recorded_farms(torch):
    """Every ReplicaFarm the workloads build while the context is open, in
    a list: the port's class replaced, where run_sol_sim and LogP import
    it, by a subclass that keeps itself."""
    import contextlib

    from molchanica_tpu_torch.parallel import replicas
    from molchanica_tpu_torch.properties import logp

    farms = []
    base = replicas.ReplicaFarm

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            farms.append(self)

    @contextlib.contextmanager
    def ctx():
        replicas.ReplicaFarm = logp.ReplicaFarm = Recorded
        try:
            yield farms
        finally:
            replicas.ReplicaFarm = logp.ReplicaFarm = base
    return ctx()


def window_blowups(farm, windows, tag, np):
    """Phases H and I on a finished farm: each window's final T and
    finiteness. Fails if a position or T is not finite, or if an end-point
    window (lambda 0 or 1) is above WINDOW_BLOWUP_K; an intermediate window
    above it is a collapse (see WINDOW_BLOWUP_K). Prints the collapsed
    windows and the TI dG without them; returns their lambdas and that
    dG."""
    from molchanica_tpu_torch.md.alchemical import free_energy_ti_with_sem

    temps = farm.temperatures()
    finite = bool(np.isfinite(farm.x.detach().cpu().numpy()).all())
    lams = np.asarray([w.lam for w in windows])
    hot = ~(temps <= WINDOW_BLOWUP_K)
    ends = hot & ((lams <= 1e-6) | (lams >= 1.0 - 1e-6))
    collapsed = [round(float(x), 4) for x in lams[hot & ~ends]]
    kept = [w for w, h in zip(windows, hot) if not h]
    dg = sem = float("nan")
    if len(kept) >= 2:
        dg, sem = free_energy_ti_with_sem(kept)
    say(f"[{tag}] windows above {WINDOW_BLOWUP_K:g} K: lambda {collapsed} "
        f"collapsed (intermediate), {lams[ends].tolist()} at an end point; "
        f"TI without the collapsed windows: decoupling dG {dg:.4f} SEM "
        f"{sem:.4f} "
        f"over {len(kept)} windows")
    if not finite or not np.isfinite(temps).all() or ends.any():
        raise SystemExit(f"{tag}: finite={finite} T={temps.tolist()}")
    return collapsed, dg


def farm_k2_phase(asys, d, torch, np):
    """Phase G: the screening farm of scripts/bench_all.py (config 5's farm
    shape) on config 3, on K2: MdSim with Langevin-middle (gamma 5/ps) at
    310 K, SHAKE, FIRE over 150 iterations, use_pallas=True from
    eq25k.npz's positions, ReplicaFarm(sim, 4, seed=3), 5 steps of 2 fs,
    then N_FARM_STEPS timed steps, K2 launches counted over exactly those
    two calls and held to the farm's force evaluations. Between the calls,
    on the farm's diverged replicas after a rebuild: one batched K2 launch
    against each replica's single launch (the same bits), each replica's
    slice against its plain version (k2 gates per slot and per cell), each
    replica's pair count against the plain count. Then each replica finite
    at 100 K < T < 600 K, and a profiler window of FARM_PROFILE_STEPS steps
    for the kernels per farm step. Returns (kernel entry, summary)."""
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)
    from molchanica_tpu_torch.md.engine import MdSim
    from molchanica_tpu_torch.ops.direct_force import (DirectForce,
                                                       cell_energies,
                                                       direct_force_cuda,
                                                       direct_force_parity,
                                                       direct_force_plain)
    from molchanica_tpu_torch.parallel.replicas import ReplicaFarm

    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=5.0),
                   temp_target=310.0, lj_cutoff=9.0, coulomb_cutoff=9.0,
                   hydrogen_constraint=HydrogenConstraint.shake(),
                   dtype="float32", max_init_relaxation_iters=150,
                   steps_per_chunk=50, seed=2, use_pallas=True)
    t0 = time.perf_counter()
    md = MdSim(asys.topology, cfg, d["x"], box_extent=asys.box_extent,
               device="cuda")
    torch.cuda.synchronize()
    r = md.relax_log
    say(f"[farm-k2] MdSim init {time.perf_counter() - t0:.1f} s (FIRE "
        f"{r['seconds']:.1f} s, path {r['path']}, block ends "
        f"{[round(e, 3) for e in r['block_ends']]}, kept {r['kept']}); "
        f"backend {md._nbr_backend} nc={md._plan.nc} "
        f"C={md._plan.capacity}")
    if md._nbr_backend != "pallas":
        raise SystemExit(f"farm: backend {md._nbr_backend}, not K2")
    farm = ReplicaFarm(md, N_FARM, seed=3)
    R = farm.n
    torch.cuda.reset_peak_memory_stats()
    DirectForce.launches = 0
    evals0 = farm.force_evals
    t0 = time.perf_counter()
    farm.step(0.002, N_FARM_WARM)
    torch.cuda.synchronize()
    say(f"[farm-k2] warm-up {N_FARM_WARM} farm steps in "
        f"{time.perf_counter() - t0:.1f} s")
    # the kernel on the diverged replicas (launches here are not counted)
    ch = farm._chunks[0]
    b = ch.b
    with torch.no_grad():
        xv = b.place(farm.x)
        (sa, _, shift), ovf = b.rebuild(xv, md.state.box)
        center, ghost = md._direct.inputs(xv, md.state.box, sa, shift)
    plan, direct = md._plan, md._direct
    couples, beta = ch.c, md._beta
    n_b = torch.zeros(R, dtype=torch.int64, device="cuda")
    out_b = direct_force_cuda(plan, center, ghost, couples, beta,
                              counts=n_b)
    worst_f = worst_e = err_max = 0.0
    pairs = []
    for k in range(R):
        out_1 = direct_force_cuda(plan, center[k], ghost[k], couples[k],
                                  beta)
        stats = {}
        out_p = direct_force_plain(center[k], ghost[k], direct.starts,
                                   couples[k], beta, direct.rc2,
                                   stats=stats)
        torch.cuda.synchronize()
        same = torch.equal(out_b[k], out_1)
        rel_f, rel_e = direct_force_parity(
            out_b[k, :, :3], cell_energies(out_b[k], plan.n_cells).sum(1),
            out_p[:, :3], stats)
        err = float((out_b[k, :, :3] - out_p[:, :3]).abs().max())
        say(f"[farm-k2] replica {k}: batched slice == single launch "
            f"bitwise: {same}; vs plain per slot {rel_f:.3e}, per cell "
            f"{rel_e:.3e} (limits {KERNEL_TOL_F:g}, {KERNEL_TOL_E:g}), "
            f"max|dF| {err:.4e}; pairs kernel {int(n_b[k])} plain "
            f"{stats['pairs']}; overflow {int(ovf[k])}")
        if not same:
            raise SystemExit(f"farm K2: replica {k}'s slice differs from "
                             "its single launch")
        if not (rel_f < KERNEL_TOL_F and rel_e < KERNEL_TOL_E):
            raise SystemExit(f"farm K2: replica {k} kernel and plain "
                             "disagree")
        if int(n_b[k]) != stats["pairs"]:
            raise SystemExit(f"farm K2: replica {k} counted {int(n_b[k])} "
                             f"pairs, plain {stats['pairs']}")
        worst_f, worst_e = max(worst_f, rel_f), max(worst_e, rel_e)
        err_max = max(err_max, err)
        pairs.append(stats["pairs"])
    if len(set(pairs)) == 1:
        raise SystemExit("farm K2: the replicas did not diverge")
    launch_b = lambda: direct_force_cuda(plan, center, ghost, couples, beta)
    launch_1 = lambda: [direct_force_cuda(plan, center[k], ghost[k],
                                          couples[k], beta)
                        for k in range(R)]
    ms_b, ms_1 = graph_ms(launch_b, 20), graph_ms(launch_1, 20)
    call_ms = cuda_ms(launch_b, 20)
    plain_ms = cuda_ms(lambda: direct_force_plain(
        center, ghost, direct.starts, couples, beta, direct.rc2), 1)
    t_ops = sum(pairs) / 2 * (K2_PAIR_OPS + K2_REACTION_OPS) \
        / PEAK_FP32 * 1e3
    nbytes = (center.numel() + ghost.numel() + 2 * R + out_b.numel()) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    say(f"[farm-k2] batched K2 over {R} replicas: {ms_b:.4f} ms (device; "
        f"{call_ms:.4f} per eager call), {R} single launches {ms_1:.4f} ms; "
        f"plain {plain_ms:.2f} ms; bound {max(t_ops, t_bytes):.5f} ms "
        f"({sum(pairs) // 2} unordered pairs x "
        f"{K2_PAIR_OPS + K2_REACTION_OPS} FP32 ops, {nbytes} bytes)")
    # the timed run
    t0 = time.perf_counter()
    farm.step(0.002, N_FARM_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = DirectForce.launches
    n_eval = farm.force_evals - evals0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_farm = elapsed / N_FARM_STEPS * 1e3
    say(f"[farm-k2] {N_FARM_STEPS} farm steps: {ms_farm:.4f} ms per farm "
        f"step, {R * N_FARM_STEPS / elapsed:.2f} replica-steps/s, "
        f"{ms_farm / R:.4f} ms per replica step; K2 launches {launches} "
        f"= farm force evaluations {n_eval} "
        f"({launches / (N_FARM_WARM + N_FARM_STEPS):.1f} per farm step); "
        f"peak device memory {peak:.3f} GiB")
    if not launches == n_eval == 2 * (N_FARM_WARM + N_FARM_STEPS):
        raise SystemExit(f"farm K2: launches {launches}, force evaluations "
                         f"{n_eval}")
    temps = farm_temperatures(farm, "farm-k2", np)
    _, _, _, dev_ms, kernels, wall = profile_calls(
        lambda: farm.step(0.002, FARM_PROFILE_STEPS), torch)
    say(f"[farm-k2] profiled {FARM_PROFILE_STEPS} farm steps: "
        f"{kernels / FARM_PROFILE_STEPS:.0f} kernels per farm step, device "
        f"busy {dev_ms / FARM_PROFILE_STEPS:.3f} of "
        f"{wall / FARM_PROFILE_STEPS:.3f} ms")
    entry = dict(
        name="direct_force_batched", route="cuda",
        source="molchanica_tpu_torch/csrc/direct_force.cu",
        replaces="molchanica_tpu/ops/pallas/direct_force.py:388",
        launches=launches, max_abs_err=err_max, ms=ms_b,
        plain_ms=plain_ms, call_ms=call_ms, single_ms=ms_1,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, replicas=R, pairs=pairs,
        site_rel_err=worst_f, cell_rel_err_e=worst_e)
    return entry, dict(ms_per_farm_step=ms_farm,
                       replica_steps_per_s=R * N_FARM_STEPS / elapsed,
                       launches=launches, force_evals=n_eval,
                       kernels_per_farm_step=kernels / FARM_PROFILE_STEPS,
                       device_ms_per_farm_step=dev_ms / FARM_PROFILE_STEPS,
                       peak_gib=peak, temperatures_K=temps.tolist(),
                       relax=dict(path=r["path"], ends=r["block_ends"],
                                  kept=r["kept"]))


def hydration_farm_phase(asys_h, cfg_h, x_rel, torch, np):
    """Phase H: the hydration farm. First its gates on phase 13's state
    (methanol in the 35 A OPC box, MdSim on the cluster backend, no FIRE,
    velocities drawn at 310 K): one batched force evaluation of a
    13-replica farm at couples 1 - HYDRATION_LAMBDAS against 13
    single-replica MdSim evaluations, per site within the card-vs-CPU
    engine gate; one farm step of two replicas on the card against the
    same on the CPU with the same noise, their batched forces at the same
    gate and the positions within dt^2 / m_min x the largest per-site
    limit. Energies are held to rel 1e-5 of |E| plus the direct space's
    |e| sums, as md_engine_parity holds the lj and coulomb terms: the
    float32 sums carry ~1e5 kcal/mol of excluded water pairs that the rest
    energy subtracts again. The 13-replica farm then steps on, with the
    kernels per farm step in a profiler window, and must stay finite at
    100 K < T < 600 K per replica. Then run_sol_sim itself at the
    reference protocol's width (all 13 windows, its own MdConfig), the
    step counts cut (FARM_FIRE, H_EQUIL, H_PROD, dhdl_interval
    H_DHDL_INTERVAL): ms
    per farm step and per window step, peak memory, the relaxation path,
    dG and SEM (not gated), each window's mean dH/dlambda beside its
    float32 FD floor, and every replica finite with the protocol's shape.
    Its windows are held to window_blowups, not to the 100-600 K band: at
    these counts its capped warm-ups are 20 + 20 steps and the box still
    holds the strain FIRE leaves (690-915 K on the card after FIRE 400,
    787-805 K after FARM_FIRE), and an
    intermediate window may collapse (WINDOW_BLOWUP_K; ROADMAP Queue 3)."""
    from molchanica_tpu_torch.constants import ACCEL_FACTOR
    from molchanica_tpu_torch.md.alchemical import HYDRATION_LAMBDAS
    from molchanica_tpu_torch.md.engine import MdSim
    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.parallel.replicas import ReplicaFarm
    from molchanica_tpu_torch.properties import run_sol_sim

    lams = np.asarray(HYDRATION_LAMBDAS)
    cfg = cfg_h.replace(use_pallas=False, max_init_relaxation_iters=None)
    # velocities drawn at 310 K by the CPU MdSim, the same on the card
    cpu = MdSim(asys_h.topology, cfg, x_rel, box_extent=asys_h.box_extent,
                device="cpu")
    sims = {"cuda": MdSim(asys_h.topology, cfg, x_rel,
                          box_extent=asys_h.box_extent,
                          velocities=cpu.state.velocities.numpy(),
                          device="cuda"), "cpu": cpu}
    g = sims["cuda"]
    farm = ReplicaFarm(g, len(lams), couples=1.0 - lams, seed=TI_SEED)
    b = farm._chunks[0].b
    box = g.state.box
    eps32 = float(np.finfo(np.float32).eps)
    floors = {}
    with torch.no_grad():
        nbr, _ = b.rebuild(b.place(farm.x), box)
        f_b, (e_b, _) = b.force(farm.x, box, farm._chunks[0].c, nbr)
        worst_f = worst_e = 0.0
        for k in range(farm.n):
            c_k = farm._chunks[0].c[k]
            f_1, (e_1, terms) = g.force_fn(farm.x[k], box, c_k)
            g.state = g.state.replace(couple=c_k)
            scale, e_scale = g.direct_space_scales(farm.x[k])
            worst_f = max(worst_f, farm_force_gate(f_b[k], f_1, scale))
            worst_e = max(worst_e, abs(float(e_b[k]) - float(e_1))
                          / (abs(float(e_1)) + sum(e_scale.values())))
            floors[round(float(lams[k]), 6)] = eps32 * (
                sum(abs(float(terms[t])) for t in (
                    "bond", "angle", "dihedral", "recip", "lj", "coulomb"))
                + sum(e_scale.values())) / (2.0 * DHDL_H)
        g.state = g.state.replace(couple=torch.ones_like(g.state.couple))
    say(f"[farm-h] one batched force of {farm.n} replicas against "
        f"{farm.n} single evaluations: worst site at {worst_f:.3e} of the "
        f"limit ({ENGINE_TOL_F:g} max|F| + {ENGINE_TOL_DIRECT:g} direct "
        f"scale), worst energy {worst_e:.2e} of |E| + the direct |e| sums "
        f"(limit 1e-5)")
    if not (worst_f <= 1.0 and worst_e <= 1e-5):
        raise SystemExit("hydration farm: batched force parts from the "
                         "single-replica force")
    # the card farm against the CPU farm: one step of two replicas from
    # the same state with the same noise; then both farms' batched force
    # at the CPU farm's positions, per site at the engine gate, and the
    # positions within dt^2 / m_min times the largest per-site limit of
    # that gate: one step moves x by dt^2 F / m, and the constraint
    # projection passes a site's error on to the others of its cluster
    two = {}
    noise = torch.randn((2,) + tuple(x_rel.shape),
                        generator=torch.Generator().manual_seed(5))
    for dev, sim in sims.items():
        f2 = ReplicaFarm(sim, 2, couples=[1.0, 0.5], seed=TI_SEED)
        f2._draws = lambda dev=dev: [noise.to(dev)]
        f2.step(0.002, 1, record_dhdl=True)
        two[dev] = f2
    c2 = {dev: f2._chunks[0] for dev, f2 in two.items()}
    x_c = two["cpu"].x
    forces = {}
    with torch.no_grad():
        for dev, ch in c2.items():
            xd = x_c.to(dev)
            nb2, _ = ch.b.rebuild(ch.b.place(xd), ch.box)
            f, (e, _) = ch.b.force(xd, ch.box, ch.c, nb2)
            forces[dev] = (f.cpu(), e.cpu())
        cpu = sims["cpu"]
        ratio2 = de2 = 0.0
        dx_ratio = 0.0
        m_min = float(cpu.top.masses[cpu.top.dof_mask > 0].min())
        dx = (two["cuda"].x.cpu() - x_c).abs().amax(dim=-1)
        for k in range(2):
            cpu.state = cpu.state.replace(couple=c2["cpu"].c[k])
            scale, e_scale = cpu.direct_space_scales(x_c[k])
            fr = forces["cpu"][0][k]
            ratio2 = max(ratio2, farm_force_gate(forces["cuda"][0][k], fr,
                                                 scale))
            de2 = max(de2, abs(float(forces["cuda"][1][k])
                               - float(forces["cpu"][1][k]))
                      / (abs(float(forces["cpu"][1][k]))
                         + sum(e_scale.values())))
            lim = float((ENGINE_TOL_F * fr.abs().max()
                         + ENGINE_TOL_DIRECT * scale).max()) \
                * ACCEL_FACTOR / m_min * 0.002 ** 2
            dx_ratio = max(dx_ratio, float(dx[k].max()) / lim)
    say(f"[farm-h] one farm step of 2 replicas, card vs CPU: batched force "
        f"at the CPU's positions, worst site at {ratio2:.3e} of the limit, "
        f"energies {de2:.2e} of |E| + the direct |e| sums; positions at "
        f"{dx_ratio:.3e} of dt^2 / m_min x the largest force limit (max|dx| "
        f"{float(dx.max()):.3e} A); dH/dl "
        f"card {np.round(two['cuda'].dhdl_trace, 3).tolist()} CPU "
        f"{np.round(two['cpu'].dhdl_trace, 3).tolist()} (float32 FD, not "
        f"gated)")
    if not (ratio2 <= 1.0 and de2 <= 1e-5 and dx_ratio <= 1.0):
        raise SystemExit("hydration farm: card and CPU farms disagree")
    del sims, two, c2
    farm.step(0.002, 2)
    _, _, _, dev_ms, kernels, wall = profile_calls(
        lambda: farm.step(0.002, FARM_PROFILE_STEPS), torch)
    say(f"[farm-h] profiled {FARM_PROFILE_STEPS} farm steps of "
        f"{farm.n} replicas: {kernels / FARM_PROFILE_STEPS:.0f} kernels "
        f"per farm step, device busy {dev_ms / FARM_PROFILE_STEPS:.3f} of "
        f"{wall / FARM_PROFILE_STEPS:.3f} ms")
    gate_temps = farm_temperatures(farm, "farm-h", np)
    del farm, b
    # run_sol_sim, the entry point
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorded_farms(torch) as farms:
        props = run_sol_sim(methanol(), equil_steps=H_EQUIL,
                            prod_steps=H_PROD,
                            dhdl_interval=H_DHDL_INTERVAL, seed=TI_SEED,
                            cfg_overrides=dict(
                                max_init_relaxation_iters=FARM_FIRE))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rm = props.run_metrics
    rx = rm["relax"]
    ms_farm = rm["farm_s"] / rm["farm_steps"] * 1e3
    n_samples = len(props.windows[0].dhdl_samples)
    say(f"[farm-h] run_sol_sim(methanol, equil {H_EQUIL}, prod {H_PROD}, "
        f"dhdl_interval {H_DHDL_INTERVAL}): {rm['n_sites']} sites x "
        f"{rm['n_replicas']} replicas, {wall_s:.1f} s; relaxation "
        f"{rx['path']} over {rx['iters']} iterations (block ends "
        f"{[round(e, 3) for e in rx['block_ends']]}, kept {rx['kept']}, "
        f"{rx['seconds']:.1f} s); {ms_farm:.4f} ms per farm step, "
        f"{ms_farm / rm['n_replicas']:.4f} ms per window step over "
        f"{rm['farm_steps']} farm steps; peak device memory {peak:.3f} GiB")
    # the float32 FD floor of each window's dH/dlambda (phase F's)
    for w in props.windows:
        say(f"[farm-h] lambda={w.lam:.2f} <dH/dl>={w.mean:10.4f} kcal/mol "
            f"over {len(w.dhdl_samples)} samples; float32 FD floor "
            f"{floors.get(round(w.lam, 6), float('nan')):.2f} (phase 13's "
            f"state)")
    temps = np.asarray(rm["temperatures_K"])
    say(f"[farm-h] run_sol_sim: T {rm['warmup_temperature_K']:.2f} K after "
        f"the capped warm-ups; T per replica at the end "
        f"{np.round(temps, 2).tolist()} K (gated at {WINDOW_BLOWUP_K:g} K "
        f"at the end points only, see WINDOW_BLOWUP_K), finite="
        f"{rm['finite']}")
    collapsed, dg_kept = window_blowups(farms[0], props.windows, "farm-h",
                                        np)
    say(f"[farm-h] dG_hydration={props.dg_hydration_kcal:.4f} kcal/mol "
        f"SEM={props.dg_sem_kcal:.4f} (not gated); contacts "
        f"{props.mean_n_water_contacts:.2f}, h_bonds "
        f"{props.mean_n_h_bonds:.2f}")
    bad = [w.lam for w in props.windows
           if not np.isfinite(w.dhdl_samples).all()
           or len(w.dhdl_samples) != n_samples]
    if bad or not np.isfinite(props.dg_hydration_kcal) \
            or n_samples != -(-H_PROD // (H_DHDL_INTERVAL + 1)) \
            or not rm["finite"]:
        raise SystemExit(f"run_sol_sim: windows {bad}, dG "
                         f"{props.dg_hydration_kcal}, finite "
                         f"{rm['finite']}")
    return dict(batched_force_ratio=worst_f, batched_energy_rel=worst_e,
                card_cpu_force_ratio=ratio2, card_cpu_energy_rel=de2,
                card_cpu_dx_ratio=dx_ratio, floors=floors,
                kernels_per_farm_step=kernels / FARM_PROFILE_STEPS,
                ms_per_farm_step=ms_farm,
                ms_per_window_step=ms_farm / rm["n_replicas"],
                peak_gib=peak, wall_s=wall_s, relax_path=rx["path"],
                block_ends=rx["block_ends"], kept=rx["kept"],
                dg=props.dg_hydration_kcal, sem=props.dg_sem_kcal,
                gate_temperatures_K=gate_temps.tolist(),
                warmup_temperature_K=rm["warmup_temperature_K"],
                temperatures_K=temps.tolist(), collapsed=collapsed,
                dg_decoupling_without_collapsed=dg_kept,
                windows=[dict(lam=w.lam, mean=w.mean)
                         for w in props.windows])


def logp_phase(torch, np):
    """Phase I: run_alchemical (LogP) on methanol at its default boxes (35
    A water, 30 A wet octanol) and LOGP_LAMBDAS, the step counts cut
    (I_EQUIL, I_PROD): each phase's sites, wall time and farm ms per step;
    finite results (dG, SEM, logP, every replica's positions), and each
    phase's windows held to window_blowups, as in phase H (20 + 20 capped
    warm-up steps here)."""
    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.properties.logp import (LOGP_LAMBDAS,
                                                      run_alchemical)

    t0 = time.perf_counter()
    with recorded_farms(torch) as farms:
        res = run_alchemical(methanol(), equil_steps=I_EQUIL,
                             prod_steps=I_PROD, seed=TI_SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(logp=res.logp, wall_s=wall)
    for farm, (tag, ph) in zip(farms, (("water", res.water),
                                       ("octanol", res.octanol)),
                               strict=True):
        rm = ph.run_metrics
        temps = np.asarray(rm["temperatures_K"])
        ms = rm["farm_s"] / rm["farm_steps"] * 1e3
        say(f"[logp] {tag}: {rm['n_sites']} sites x {len(ph.windows)} "
            f"windows, {ms:.4f} ms per farm step over {rm['farm_steps']}; "
            f"dG {ph.dg_kcal_mol:.4f} SEM {ph.dg_sem_kcal_mol:.4f}; T per "
            f"replica {np.round(temps, 1).tolist()} K, finite="
            f"{rm['finite']}")
        collapsed, dg_kept = window_blowups(farm, ph.windows,
                                            f"logp-{tag}", np)
        if not (rm["finite"] and np.isfinite(ph.dg_kcal_mol)
                and np.isfinite(ph.dg_sem_kcal_mol)
                and len(ph.windows) == len(LOGP_LAMBDAS)):
            raise SystemExit(f"LogP {tag} phase: finite {rm['finite']}, "
                             f"dG {ph.dg_kcal_mol}, T {temps.tolist()}")
        out[tag] = dict(n_sites=rm["n_sites"], ms_per_farm_step=ms,
                        dg=ph.dg_kcal_mol, sem=ph.dg_sem_kcal_mol,
                        temperatures_K=temps.tolist(), collapsed=collapsed,
                        dg_without_collapsed=dg_kept)
    say(f"[logp] logP {res.logp:.4f} (not gated: {I_PROD} production "
        f"steps), {wall:.1f} s")
    if not np.isfinite(res.logp):
        raise SystemExit("LogP: non-finite logP")
    return out


def dryrun_properties_phase(torch, np):
    """Phase J: the replica-TI dry run with its replica axis cut into two
    chunks on the card against the unsplit farm (positions within
    J_SPLIT_TOL A, dH/dlambda samples within J_SPLIT_TOL of their largest
    magnitude), then the four properties once each at small step counts:
    the crystal (8 methanol-like copies, dry; J_STEPS steps), the
    shrinking box (10 copies to 0.7 g/cm^3 in stages of J_STAGE steps,
    its mixing diagnostics over 3 of them as solutes), the boundary layer
    (80 slab waters, J_STEPS steps)."""
    from molchanica_tpu_torch.molecules.spec import MolSpec
    from molchanica_tpu_torch.parallel.dryrun import dryrun_replica_ti
    from molchanica_tpu_torch.properties.boundary_layer import \
        run_boundary_layer_sol_sim
    from molchanica_tpu_torch.properties.crystal import run_crystal_sim
    from molchanica_tpu_torch.properties.shrinking_box import \
        run_shrinking_box_sim

    t0 = time.perf_counter()
    one = dryrun_replica_ti(J_WINDOWS)
    two = dryrun_replica_ti(J_WINDOWS, devices=["cuda", "cuda"])
    dx = float(np.abs(one["x"] - two["x"]).max())
    s1, s2 = np.asarray(one["samples"]), np.asarray(two["samples"])
    ds = float(np.abs(s1 - s2).max() / max(np.abs(s1).max(), 1e-30))
    say(f"[dryrun-ti] {J_WINDOWS} windows, one chunk vs two chunks on the "
        f"card: max|dx| {dx:.3e} A, dH/dl {ds:.3e} of max|dH/dl| (limits "
        f"{J_SPLIT_TOL:g}); dG {one['dg']:.4f} / {two['dg']:.4f}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (dx <= J_SPLIT_TOL and ds <= J_SPLIT_TOL
            and len(two["devices"]) == 2):
        raise SystemExit("replica-TI dry run: the split farm parts from "
                         "the unsplit one")

    mol = MolSpec(
        masses=[12.011, 1.008, 1.008, 1.008, 15.999, 1.008],
        charges=[0.12, 0.04, 0.04, 0.04, -0.60, 0.36],
        lj_sigma=[3.4, 2.47, 2.47, 2.47, 3.07, 0.0],
        lj_eps=[0.11, 0.016, 0.016, 0.016, 0.21, 0.0],
        positions=np.array([[0.0, 0, 0], [0.36, 1.03, 0],
                            [0.36, -0.51, 0.89], [0.36, -0.51, -0.89],
                            [-1.41, 0, 0], [-1.74, -0.9, 0]]),
        bonds=[(0, 1, 340.0, 1.09), (0, 2, 340.0, 1.09),
               (0, 3, 340.0, 1.09), (0, 4, 320.0, 1.41),
               (4, 5, 553.0, 0.96)],
        angles=[(1, 0, 2, 35.0, 1.911), (1, 0, 3, 35.0, 1.911),
                (2, 0, 3, 35.0, 1.911), (1, 0, 4, 50.0, 1.911),
                (2, 0, 4, 50.0, 1.911), (3, 0, 4, 50.0, 1.911),
                (0, 4, 5, 55.0, 1.894)],
        hclusters=[(0, [1, 2, 3], [1.09] * 3), (4, [5], [0.96])])
    out = dict(dryrun_dx=dx, dryrun_dhdl_rel=ds)
    t0 = time.perf_counter()
    cry, _ = run_crystal_sim(mol, requested_copies=8, n_steps=J_STEPS,
                             dt_ps=0.001, cfg_overrides=dict(
                                 max_init_relaxation_iters=150))
    t1 = time.perf_counter()
    say(f"[props] crystal: {cry.copy_count} copies, cohesive "
        f"{cry.cohesive_energy_kcal_per_mol:.4f} kcal/mol, T "
        f"{cry.temperature_k:.1f} K, {t1 - t0:.1f} s")
    shr = run_shrinking_box_sim(
        [mol] * 10, target_density_g_cm3=0.7, steps_per_stage=J_STAGE,
        solute_indices=[0, 1, 2], cfg_overrides=dict(
            max_init_relaxation_iters=100))
    t2 = time.perf_counter()
    say(f"[props] shrinking box: density {shr.final_density_g_cm3:.4f} "
        f"g/cm^3 (target 0.7) after {shr.shrink_steps} shrink steps, T "
        f"{shr.temperature_k:.1f} K, {t2 - t1:.1f} s")
    bl = run_boundary_layer_sol_sim(
        mol, slab_waters=80, box_xy=14.0, box_z=40.0, n_steps=J_STEPS,
        cfg_overrides=dict(max_init_relaxation_iters=100, lj_cutoff=6.5,
                           coulomb_cutoff=6.5))
    t3 = time.perf_counter()
    say(f"[props] boundary layer: Gibbs surface {bl.gibbs_surface_z_a:.2f} "
        f"A, solute depth {bl.solute_depth_a:.2f} A, surface affinity "
        f"{bl.surface_affinity:.2f}, T {bl.temperature_k:.1f} K, "
        f"{t3 - t2:.1f} s")
    mix = shr.mixing
    say(f"[props] mixing diagnostics of the shrinking box (3 solutes): "
        f"score {mix.score:.4f}, largest cluster fraction "
        f"{mix.largest_cluster_fraction:.3f}")
    vals = (cry.cohesive_energy_kcal_per_mol, cry.temperature_k,
            shr.final_density_g_cm3, shr.temperature_k,
            bl.temperature_k, bl.surface_affinity, mix.score)
    if not (np.isfinite(vals).all() and cry.copy_count >= 4
            and shr.final_density_g_cm3 > 0.6
            and bl.density_profile.sum() > 0):
        raise SystemExit(f"properties: {vals}")
    out.update(crystal_cohesive=cry.cohesive_energy_kcal_per_mol,
               crystal_s=t1 - t0, shrink_density=shr.final_density_g_cm3,
               shrink_s=t2 - t1, boundary_affinity=bl.surface_affinity,
               boundary_s=t3 - t2, mixing_score=mix.score)
    return out


def load_pocket():
    """The fixture through the port's readers and GAFF2 chain: (pocket,
    ligand molecule, receptor spec, ligand spec, site, typing seconds)."""
    from molchanica_tpu_torch.docking import DockingSite
    from molchanica_tpu_torch.io import read_sdf
    from molchanica_tpu_torch.molecules.pocket import MoleculePocket

    lig = read_sdf(POCKET_SDF)
    pocket = MoleculePocket.from_file(POCKET_PDB, pdb_id="fixture",
                                      ligand=lig)
    t0 = time.perf_counter()
    rec = pocket.mol.to_spec(strict=False)
    lig_s = lig.to_spec(strict=False)
    typing_s = time.perf_counter() - t0
    c, r = pocket.docking_site()
    site = DockingSite(site_center=c,
                       site_radius=min(float(r), DOCK_SITE_RADIUS))
    return pocket, lig, rec, lig_s, site, typing_s


def score_gate(be, be_c, mag, n_pairs, np):
    """score_poses on the card (be) against the CPU (be_c): (clash masks
    equal, +inf totals on the same poses and only on clashes, per term
    the worst error over the poses in units of its limit, DOCK_TOL of
    the pose's pair-term scale `mag` plus the smallest normal float32 per
    pair for subnormal terms)."""
    from molchanica_tpu_torch.docking.scorer import TERMS

    floor = float(np.finfo(np.float32).tiny) * n_pairs
    worst = {}
    for k in TERMS + ("total",):
        a = getattr(be_c, k).astype(np.float64)
        b = getattr(be, k).astype(np.float64)
        keep = np.isfinite(a)
        err = np.abs(a[keep] - b[keep])
        worst[k] = float((err / (DOCK_TOL * mag[k][keep] + floor)).max())
    same_clash = bool(np.array_equal(be.clash, be_c.clash))
    same_inf = bool(np.array_equal(np.isinf(be.total), np.isinf(be_c.total))
                    and np.array_equal(np.isinf(be.total), be.clash))
    return same_clash, same_inf, worst


def docking_phase(torch, np):
    """Phase K: the fixture typed by the port (804-atom receptor, 33-atom
    ligand), the site at the ligand's centroid with radius min(r, 9),
    DockingSetup on the card and the reference's pose budget (init_poses
    n_grid 8, 60 orientations: 27,360 poses); score_poses on the card (a
    warm-up call, then a timed one) held against the CPU over the same
    poses: clash masks identical, +inf totals on the same poses, per term
    and pose within DOCK_TOL of its pair-term scale, the best DOCK_TOP
    totals alike; the fixture test's contract (unclashed totals finite, at
    least 10 survive, the best below 0); one batch again with H-bond
    donors on the ligand (card vs CPU, the H-bond term nonzero); one
    batch's device time under the profiler, peak memory, find_sites."""
    from molchanica_tpu_torch.docking import (DockingSetup, find_sites,
                                              init_poses)
    import dataclasses

    from molchanica_tpu_torch.docking.scorer import (DEFAULT_BATCH,
                                                     make_pose_scorer,
                                                     pose_term_magnitudes,
                                                     score_poses)

    pocket, lig, rec, lig_s, site, typing_s = load_pocket()
    setup = DockingSetup.new(rec, site)
    poses = init_poses(lig_s.positions, site.site_center,
                       site_radius=float(site.site_radius), n_grid=DOCK_GRID,
                       n_orientations=DOCK_ORIENTATIONS)
    n_p, n_l, n_r = poses.shape[0], poses.shape[1], setup.rec_pos.shape[0]
    say(f"[dock] fixture: receptor {rec.n_atoms} atoms, ligand "
        f"{lig_s.n_atoms} atoms, typed in {typing_s:.3f} s; site r = "
        f"{float(site.site_radius):.2f} A; {setup.n_rec_real} receptor atoms "
        f"culled, R = {n_r}; {n_p} poses = {n_p * n_l * n_r:,} pairs")
    if n_p != 27360:
        raise SystemExit(f"docking: {n_p} poses, not the reference's 27,360")
    score_poses(setup, lig_s, poses)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    be = score_poses(setup, lig_s, poses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    be_c = score_poses(setup, lig_s, poses, device="cpu")
    cpu_s = time.perf_counter() - t0
    mag = pose_term_magnitudes(setup, lig_s, poses)
    same_clash, same_inf, worst = score_gate(be, be_c, mag, n_l * n_r, np)
    top_g = np.sort(be.total)[:DOCK_TOP].astype(np.float64)
    top_c = np.sort(be_c.total)[:DOCK_TOP].astype(np.float64)
    top_err = float(np.abs(top_g - top_c).max())
    top_lim = DOCK_TOL * float(mag["total"][np.isfinite(be.total)].max())
    alive = ~be.clash
    n_alive = int(alive.sum())
    best = float(be.total.min())
    say(f"[dock] score_poses on the card: {wall * 1e3:.3f} ms for {n_p} "
        f"poses = {n_p / wall:,.0f} poses/s (batch {DEFAULT_BATCH}, "
        f"{-(-n_p // DEFAULT_BATCH)} batches); peak memory {peak:.3f} GiB; "
        f"the CPU's {cpu_s:.2f} s")
    say(f"[dock] card vs CPU: clash masks equal {same_clash}, +inf on the "
        f"same poses {same_inf}; worst error per term in units of its "
        f"limit (DOCK_TOL x the pose's pair-term scale + subnormal floor): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; best {DOCK_TOP} totals max|d| {top_err:.3e} (limit "
        f"{top_lim:.3e})")
    say(f"[dock] contract: {n_alive} of {n_p} poses survive the clash cull, "
        f"best total {best:.4f} kcal/mol (pose {int(np.argmin(be.total))}), "
        f"lj {float(be.lj[np.argmin(be.total)]):.4f}, coulomb "
        f"{float(be.coulomb[np.argmin(be.total)]):.4f}")
    if not (same_clash and same_inf and max(worst.values()) <= 1.0
            and top_err <= top_lim):
        raise SystemExit("docking scorer: card and CPU disagree")
    if not (np.isfinite(be.total[alive]).all() and n_alive >= 10
            and best < 0.0):
        raise SystemExit(f"docking contract: {n_alive} survive, best {best}")
    # Gasteiger gives no hydrogen of the fixture a charge above 0.25, so
    # the H-bond term is zero above: one batch again with the elements'
    # rules and the ligand's hydrogens at +0.3 (its carbons take the
    # balance), card vs CPU
    el_l = lig.elements
    q = np.asarray(lig_s.charges, float).copy()
    h = np.array([e == "H" for e in el_l])
    cb = np.array([e == "C" for e in el_l])
    q[h] = 0.3
    q[cb] -= (q.sum() - float(np.sum(lig_s.charges))) / cb.sum()
    lig_d = dataclasses.replace(lig_s, charges=q)
    setup_e = DockingSetup.new(rec, site, elements=pocket.mol.elements)
    sub = poses[:DEFAULT_BATCH]
    be_d = score_poses(setup_e, lig_d, sub, el_l)
    be_dc = score_poses(setup_e, lig_d, sub, el_l, device="cpu")
    mag_d = pose_term_magnitudes(setup_e, lig_d, sub, el_l)
    same_d = score_gate(be_d, be_dc, mag_d, n_l * n_r, np)
    n_hb = int((np.abs(be_d.h_bonds) > 0).sum())
    say(f"[dock] donors (ligand H at +0.3), {len(sub)} poses: {n_hb} with "
        f"H-bonds, clash masks equal {same_d[0]}, +inf alike {same_d[1]}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in same_d[2].items()))
    if not (same_d[0] and same_d[1] and max(same_d[2].values()) <= 1.0
            and n_hb > 0):
        raise SystemExit("docking scorer with donors: card and CPU disagree")
    scorer = make_pose_scorer(setup, lig_s)
    batch = torch.as_tensor(poses[:DEFAULT_BATCH], device=setup.device)
    _, _, _, dev_ms, kernels, prof_wall = profile_calls(
        lambda: scorer(batch), torch)
    say(f"[dock] one batch of {DEFAULT_BATCH} poses under the profiler: "
        f"device {dev_ms:.3f} ms in {kernels} kernels, wall "
        f"{prof_wall:.3f} ms")
    t0 = time.perf_counter()
    sites = find_sites(rec.positions)
    sites_s = time.perf_counter() - t0
    say(f"[dock] find_sites: {len(sites)} sites in {sites_s:.3f} s (host)")
    if not sites:
        raise SystemExit("find_sites found no site on the fixture")
    return dict(n_poses=n_p, n_pairs=n_p * n_l * n_r, n_rec=setup.n_rec_real,
                R=n_r, wall_ms=wall * 1e3, poses_per_s=n_p / wall,
                peak_gib=peak, cpu_s=cpu_s, worst_over_limit=worst,
                survive=n_alive, best_total=best, batch_device_ms=dev_ms,
                batch_kernels=kernels, batch_wall_ms=prof_wall,
                n_sites=len(sites), typing_s=typing_s)


def allpairs_parity(md_g, md_c, method, tag, torch):
    """Phase 28's gate for a dense (allpairs or allpairs_cutoff) MdSim: its
    force on the card against the same MdSim on the CPU at the CPU's
    initial positions within 1e-4 of max|F|, the potential energy within
    rel 1e-5; each energy term is printed. Returns (max|dF|, max|F|, the
    energy's rel error)."""
    x_c = md_c.state.positions
    with torch.no_grad():
        f_g, (e_g, t_g) = md_g.force_fn(x_c.to(md_g.device), md_g.state.box,
                                        md_g.state.couple)
        f_c, (e_c, t_c) = md_c.force_fn(x_c, md_c.state.box,
                                        md_c.state.couple)
    err = float((f_g.cpu() - f_c).abs().max())
    f_max = float(f_c.abs().max())
    e_rel = abs(float(e_g) - float(e_c)) / abs(float(e_c))
    terms = ", ".join(
        f"{k} {abs(float(t_g[k]) - float(t_c[k])) / abs(float(t_c[k])):.1e}"
        for k in ("bond", "angle", "dihedral", "lj", "coulomb")
        if float(t_c[k]) != 0.0)
    say(f"[{tag}] method {md_g.method}; force card vs CPU max|dF|="
        f"{err:.3e} (max|F|={f_max:.3f}); energy {float(e_g):.4f} vs "
        f"{float(e_c):.4f} rel {e_rel:.2e}; terms rel: {terms}")
    if md_g.method != method or err > 1e-4 * f_max or e_rel > 1e-5:
        raise SystemExit(f"{tag}: {method} force parity failed")
    return err, f_max, e_rel


def shoot_phase(torch, np):
    """Phase L: on the fixture's specs and site, the assembled system of
    the first shot (its allpairs force and energy card vs CPU at phase
    28's gate, 1e-4 of max|F| and rel 1e-5), then dock_md_multi on the
    card at dock_md's defaults but SHOT_STEPS steps (of 2 fs, 120 A/ps,
    float32, FIRE 200) with N_SHOTS shots: every trace value and ligand_final
    finite, each shot's closest approach to the site below its start
    distance, and the closest of all below START_DIST. A shot starts
    START_DIST out, or further where the receptor is in the way (the
    fixture's site lies inside the globule: of 6 shots, two started 23
    and 24 A out), so the receptor can stop a shot short of the site. Each MdSim
    is timed through a subclass (FIRE at construction, the step calls
    between synchronizes), which also keeps the ligand's start."""
    from molchanica_tpu_torch.docking import shoot

    _, _, rec, lig_s, site, _ = load_pocket()
    c = np.asarray(site.site_center, float)
    # the first shot's approach (dock_md_multi's k = 0) and system
    z = 1.0 - 1.0 / N_SHOTS
    approach = np.array([np.sqrt(1.0 - z * z), 0.0, z])
    asys = shoot.shot_system(rec, lig_s, c, approach)
    cfg = shoot.shot_config()
    md_g = shoot.MdSim(asys.topology, cfg, asys.positions, relax=False,
                       device="cuda")
    md_c = shoot.MdSim(asys.topology, cfg, asys.positions, relax=False,
                       device="cpu")
    say(f"[shoot] system {asys.topology.n_atoms_real} atoms")
    err, f_max, e_rel = allpairs_parity(md_g, md_c, "allpairs", "shoot",
                                        torch)

    timings = []

    class Timed(shoot.MdSim):
        def __init__(self, top, cfg, x0, **kw):
            super().__init__(top, cfg, x0, **kw)
            self._outer = True
            lig0 = np.asarray(x0)[rec.n_atoms:rec.n_atoms + lig_s.n_atoms]
            timings.append(dict(fire_s=self.relax_log["seconds"],
                                steps=0, step_s=0.0, sim=self,
                                start=float(np.linalg.norm(
                                    lig0.mean(0) - c))))

        def step(self, dt_ps, n_steps=1, *a, **kw):
            # the caller's calls only (a long call steps itself in chunks)
            outer, self._outer = self._outer, False
            t0 = time.perf_counter()
            try:
                return super().step(dt_ps, n_steps, *a, **kw)
            finally:
                self._outer = outer
                if outer:
                    torch.cuda.synchronize()
                    timings[-1]["step_s"] += time.perf_counter() - t0
                    timings[-1]["steps"] += n_steps

    base, shoot.MdSim = shoot.MdSim, Timed
    try:
        t0 = time.perf_counter()
        shots = shoot.dock_md_multi(rec, lig_s, n_shots=N_SHOTS,
                                    site_center=c, n_steps=SHOT_STEPS)
        wall = time.perf_counter() - t0
    finally:
        shoot.MdSim = base
    ms = [1e3 * tm["step_s"] / tm["steps"] for tm in timings]
    fire = [tm["fire_s"] for tm in timings]
    lig_rows = slice(rec.n_atoms, rec.n_atoms + lig_s.n_atoms)
    starts, ok = [], len(shots) == len(timings) == N_SHOTS
    for k, s in enumerate(shots):
        # the shot's MdSim: the one whose ligand ended at ligand_final
        tm = [m for m in timings if np.array_equal(
            m["sim"].state.positions[lig_rows].cpu().numpy(),
            s.ligand_final)]
        start = tm[0]["start"] if len(tm) == 1 else float("nan")
        starts.append(start)
        say(f"[shoot] shot (best first) {k}: best "
            f"{s.best_interaction_kcal:.4f} final "
            f"{s.final_interaction_kcal:.4f} kcal/mol, closest "
            f"{s.min_site_distance:.3f} A to the site from a start "
            f"{start:.3f} A out")
        ok = ok and bool(np.isfinite(s.interaction_trace).all()
                         and np.isfinite(s.ligand_final).all()
                         and s.min_site_distance < start)
    closest = min(s.min_site_distance for s in shots)
    say(f"[shoot] {N_SHOTS} shots in {wall:.1f} s: ms/step "
        + ", ".join(f"{v:.3f}" for v in ms) + "; FIRE s "
        + ", ".join(f"{v:.2f}" for v in fire)
        + f"; closest approach {closest:.3f} A (limit {shoot.START_DIST})")
    if not (ok and closest < shoot.START_DIST):
        raise SystemExit("MD shots: non-finite, or no approach to the site")
    return dict(n_shots=N_SHOTS, wall_s=wall, ms_per_step=ms, fire_s=fire,
                best=[s.best_interaction_kcal for s in shots],
                final=[s.final_interaction_kcal for s in shots],
                min_site_distance=[s.min_site_distance for s in shots],
                start_distance=starts, force_err=err, force_max=f_max,
                energy_rel=e_rel)


def density_phase(torch, np):
    """Phase M: density_from_atoms of the 804-atom receptor on the card in
    a cubic cell with DENSITY_MARGIN A on each side at about DENSITY_STEP
    A spacing, against the CPU (DENSITY_TOL of max|rho|); the round trip
    through density_map_from_sf on the card of the map's structure factors
    (a forward FFT, every h, k, l up to the grid's Nyquist; DENSITY_TOL of
    max|rho|); sample_density at the receptor's atoms card vs CPU
    (SAMPLE_TOL of max|rho|); density_rect around the ligand; the
    molecular surface of the site-culled receptor."""
    from molchanica_tpu_torch.density import (density_from_atoms,
                                              density_map_from_sf,
                                              density_rect, sample_density)
    from molchanica_tpu_torch.sfc_mesh import molecular_surface

    pocket, lig, rec, _, site, _ = load_pocket()
    x = np.asarray(rec.positions, float)
    z = np.array([ATOMIC_NUMBER[e] for e in pocket.mol.elements], float)
    lo = x.min(0) - DENSITY_MARGIN
    side = float((x.max(0) - x.min(0)).max() + 2 * DENSITY_MARGIN)
    n = int(round(side / DENSITY_STEP))
    grid, cell = (n, n, n), (side, side, side)
    density_from_atoms(x - lo, z, cell, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dm = density_from_atoms(x - lo, z, cell, grid)
    torch.cuda.synchronize()
    dens_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dm_c = density_from_atoms(x - lo, z, cell, grid, device="cpu")
    dens_cpu_s = time.perf_counter() - t0
    rho_max = float(np.abs(dm_c.data).max())
    d_err = float(np.abs(dm.data.astype(np.float64) - dm_c.data).max())
    say(f"[density] receptor {len(x)} atoms, cell {side:.3f} A, grid {n}^3 "
        f"({side / n:.4f} A): card {dens_s * 1e3:.3f} ms, CPU "
        f"{dens_cpu_s * 1e3:.1f} ms; max|d rho| {d_err:.3e} = "
        f"{d_err / rho_max:.3e} of max|rho| {rho_max:.4f} (limit "
        f"{DENSITY_TOL:g})")
    if not (np.isfinite(dm.data).all() and d_err <= DENSITY_TOL * rho_max):
        raise SystemExit("density_from_atoms: card and CPU disagree")

    rho = dm.data.astype(np.float64)
    F = np.fft.fftn(rho) * np.prod(cell) / rho.size
    idx = np.indices(grid).reshape(3, -1)
    h, k, l = (np.rint(np.fft.fftfreq(n) * n).astype(int)[i] for i in idx)
    f = F[tuple(idx)]
    t0 = time.perf_counter()
    back = density_map_from_sf(h, k, l, re=f.real, im=f.imag, grid=grid,
                               cell=cell)
    torch.cuda.synchronize()
    sf_s = time.perf_counter() - t0
    sf_err = float(np.abs(back.data - rho).max())
    say(f"[density] structure factors of the map ({len(h):,} reflections, "
        f"|h|,|k|,|l| up to {n // 2}) back through density_map_from_sf on "
        f"the card in {sf_s * 1e3:.1f} ms: max|d rho| {sf_err / rho_max:.3e}"
        f" of max|rho| (limit {DENSITY_TOL:g})")
    if not sf_err <= DENSITY_TOL * rho_max:
        raise SystemExit("density_map_from_sf round trip failed")

    dm.origin = lo
    t0 = time.perf_counter()
    s_g = sample_density(dm, x)
    sample_s = time.perf_counter() - t0
    s_c = sample_density(dm, x, device="cpu")
    s_err = float(np.abs(s_g - s_c).max())
    rect = density_rect(dm, lig.positions)
    covers = bool(np.all(rect.origin <= lig.positions.min(0))
                  and np.all(rect.origin + np.asarray(rect.cell)
                             >= lig.positions.max(0)))
    say(f"[density] sample_density at the {len(x)} atoms: card "
        f"{sample_s * 1e3:.3f} ms, card vs CPU max|d| {s_err:.3e} (limit "
        f"{SAMPLE_TOL:g} of max|rho|), mean {float(s_g.mean()):.4f}; "
        f"density_rect around the ligand {rect.dims}, covers it {covers}")
    if not (s_err <= SAMPLE_TOL * rho_max and np.isfinite(s_g).all()
            and covers):
        raise SystemExit("sample_density / density_rect failed")

    near = np.linalg.norm(x - np.asarray(site.site_center), axis=1) \
        < float(site.site_radius) + 6.0
    t0 = time.perf_counter()
    mesh = molecular_surface(x[near])
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    say(f"[density] molecular_surface of the {int(near.sum())} site-culled "
        f"receptor atoms: {mesh.n_triangles} triangles, {len(mesh.vertices)}"
        f" vertices, area {mesh.area():.3f} A^2, {mesh_s:.2f} s")
    if not (mesh.n_triangles > 0 and np.isfinite(mesh.vertices).all()
            and np.all(mesh.vertices.min(0) < x[near].min(0))
            and np.all(mesh.vertices.max(0) > x[near].max(0))):
        raise SystemExit("molecular_surface: empty or does not enclose")
    return dict(grid=n, cell=side, density_ms=dens_s * 1e3,
                density_cpu_ms=dens_cpu_s * 1e3, density_err=d_err / rho_max,
                sf_ms=sf_s * 1e3, sf_err=sf_err / rho_max,
                sample_ms=sample_s * 1e3, sample_err=s_err,
                rect_dims=list(rect.dims), mesh_atoms=int(near.sum()),
                triangles=mesh.n_triangles, area=mesh.area(),
                mesh_s=mesh_s)


def quickstart_build(cfg, device):
    """The README's quick start on the committed ligand: open_file, then
    build_dynamics of one MolDynamics with the file's elements, positions
    and bonds under cfg on `device`. Returns (sim, molecule)."""
    from molchanica_tpu_torch.io import open_file
    from molchanica_tpu_torch.md.dynamics import MolDynamics, build_dynamics

    mol = open_file(POCKET_SDF)
    sim = build_dynamics([MolDynamics(elements=mol.elements,
                                      atom_posits=mol.positions,
                                      bonds=mol.bonds)], cfg, device=device)
    return sim, mol


def quickstart_cfg(pad=QS_PAD):
    """README's MdConfig: Langevin-middle (gamma 1) at 310 K in OPC, the
    rest default (FIRE 200 at construction, float32), at a pad of `pad`
    A (the README's default is 10)."""
    from molchanica_tpu_torch.md.config import (Integrator, MdConfig,
                                                SimBoxInit, Solvent)
    return MdConfig(integrator=Integrator.langevin_middle(gamma=1.0),
                    temp_target=310.0, solvent=Solvent.water_opc(),
                    sim_box=SimBoxInit.pad_(pad))


def quickstart_phase(n_steps, torch, np):
    """Phase N: the README's quick start on the committed ligand
    (ibuprofen, 33 atoms): open_file, MolDynamics, build_dynamics with
    the README's MdConfig on the card (FIRE at construction), then
    run_dynamics_blocking(sim, 0.002, n, n/4) timed between synchronizes.
    Prints the README's own pad's site count and method, then this pad's
    method, real and padded sites, box, FIRE's wall time, ms/step and
    ns/day. Gates: the cluster backend; the built system's force on the
    card against the CPU at the initial state (md_engine_parity, phase
    10's gate); finite positions, 100 K < T < 600 K, rigid waters, four
    snapshots. Returns (results, sim, molecule)."""
    from molchanica_tpu_torch.md.dynamics import run_dynamics_blocking

    cfg_readme = quickstart_cfg(QS_README_PAD).replace(
        max_init_relaxation_iters=None)
    readme = quickstart_build(cfg_readme, "cuda")[0]
    say(f"[N] the README's pad of {QS_README_PAD:g} A: "
        f"{readme.assembled.topology.n_atoms_real} sites "
        f"({readme.top.n_atoms} padded), method {readme.method}; this run "
        f"pads {QS_PAD:g} A")
    allpairs_parity(readme, quickstart_build(cfg_readme, "cpu")[0],
                    "allpairs_cutoff", "N", torch)
    del readme
    cfg = quickstart_cfg()
    t0 = time.perf_counter()
    sim, mol = quickstart_build(cfg, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    a, r = sim.assembled, sim.relax_log
    box = [float(v) for v in a.box_extent]
    say(f"[N] open_file + build_dynamics {build_s:.2f} s: {mol.n_atoms} "
        f"ligand atoms, {a.n_waters} OPC waters, "
        f"{a.topology.n_atoms_real} real sites ({a.topology.n_atoms} "
        f"padded), box {box[0]:.4f} x {box[1]:.4f} x {box[2]:.4f} A, "
        f"method {sim.method} ({sim._nbr_backend}); FIRE {r['iters']} "
        f"iterations in {r['seconds']:.2f} s ({r['path']}, kept "
        f"{r['kept']}), E {r['e_first']:.3f} -> {r['e_last']:.3f} kcal/mol")
    if sim._nbr_backend != "clusters":
        raise SystemExit(f"phase N: {sim.method} {sim._nbr_backend}")
    md_engine_parity(lambda dev: quickstart_build(
        cfg.replace(max_init_relaxation_iters=None), dev)[0], torch)
    interval = max(n_steps // 4, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = run_dynamics_blocking(sim, 0.002, n_steps, interval)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ms_step = elapsed / n_steps * 1e3
    ns_day = n_steps * 0.002 / 1000.0 / elapsed * 86400.0
    t_final = sim.temperature()
    finite = bool(torch.isfinite(sim.state.positions).all())
    rigid = md_rigid_error(sim, np)
    temps = snapshot_temperatures(sim, snaps, np)
    say(f"[N] run_dynamics_blocking(sim, 0.002, {n_steps}, {interval}): "
        f"{ms_step:.4f} ms/step, {ns_day:.3f} ns/day, T {t_final:.2f} K, "
        f"{len(snaps)} snapshots (T {', '.join(f'{v:.1f}' for v in temps)}"
        f" K), rigid waters |d(O-H) - r_OH| {rigid:.2e} A, finite={finite}")
    if not finite or not 100.0 < t_final < 600.0 or len(snaps) != 4 \
            or not rigid < RIGID_TOL:
        raise SystemExit(f"quick start run: finite={finite} T={t_final} "
                         f"snapshots={len(snaps)} rigid={rigid}")
    return dict(method=sim.method, backend=sim._nbr_backend,
                sites=int(a.topology.n_atoms_real),
                padded=int(a.topology.n_atoms), waters=int(a.n_waters),
                box=box, build_s=build_s, fire_s=r["seconds"],
                fire_iters=r["iters"], ms_per_step=ms_step,
                ns_per_day=ns_day, temperature_K=t_final,
                snapshot_T=temps), sim, mol


def ligand_k2_phase(n_warm, n_steps, torch, np):
    """Phase O: the quick start's ligand through K2: build_dynamics with
    N's config in a fixed cube and use_pallas=True (cells_pme on the
    cell-grid kernel, FIRE on it at construction). First the hydration
    protocol's 35 A cube, which K2's plan refuses (no fallback); then
    O_BOX. K2 against its plain version on the built state's grid
    (k2_check), then md_path over n_warm and n_steps (timed) steps:
    launches equal to the force evaluations. Returns (results, MdSim)."""
    from molchanica_tpu_torch.md.config import SimBoxInit
    from molchanica_tpu_torch.md.energy import apply_virtual_sites

    cfg = quickstart_cfg().replace(use_pallas=True)
    try:
        quickstart_build(cfg.replace(
            sim_box=SimBoxInit.new_cube(O_REFUSED_BOX)), "cuda")
    except AssertionError as e:
        say(f"[O] the {O_REFUSED_BOX:g} A cube on K2 is refused: {e}")
    else:
        raise SystemExit(f"the {O_REFUSED_BOX:g} A cube should overflow "
                         "K2's cell capacity")
    t0 = time.perf_counter()
    md, _ = quickstart_build(cfg.replace(sim_box=SimBoxInit.new_cube(O_BOX)),
                             "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    a, r, plan = md.assembled, md.relax_log, md._plan
    say(f"[O] build_dynamics in the {O_BOX:g} A cube with use_pallas "
        f"{build_s:.2f} s: {a.topology.n_atoms_real} real sites "
        f"({a.topology.n_atoms} padded), {a.n_waters} OPC waters, method "
        f"{md.method} ({md._nbr_backend}), nc={plan.nc} C={plan.capacity};"
        f" FIRE {r['iters']} iterations in {r['seconds']:.2f} s "
        f"({r['path']}, kept {r['kept']}), E {r['e_first']:.3f} -> "
        f"{r['e_last']:.3f} kcal/mol")
    if md.method != "cells_pme" or md._nbr_backend != "pallas":
        raise SystemExit(f"phase O: {md.method} {md._nbr_backend}")
    s = md.state
    xv = apply_virtual_sites(s.positions, md.top)
    sa, _, ovf = md._rebuild(xv, s.box)
    center, ghost = md._direct.inputs(xv, s.box, sa)
    errs, _, _ = k2_check("O direct_force", plan, md._direct, center, ghost,
                          s.couple, md._beta, torch)
    res = md_path(md, [n_warm, n_steps], torch, np, tag="O")
    res.update(sites=int(a.topology.n_atoms_real), waters=int(a.n_waters),
               box=O_BOX, build_s=build_s, fire_s=r["seconds"],
               fire_iters=r["iters"], k2_rel_f=errs["rel_f"],
               overflow=int(ovf))
    return res, md


def checkpoint_trajectory_phase(md, sim_n, mol, torch, np):
    """Phase P: save_checkpoint on O's card state, N_CKPT_STEPS steps,
    load_checkpoint (the restored state equal to the saved one bit for
    bit: positions, velocities, box, step, couple, generator state), the
    same steps again: the two continuations bitwise equal; launch_md of
    N_CKPT_STEPS more steps joined from its thread (K2 launched there).
    Then N's snapshots written as DCD, TRR, XTC (XTC_PRECISION) and GRO,
    reopened through Trajectory.open (its frame count) and
    load_snaps(FrameSlice(start=1)), the GRO's frames through
    io.gro.read_gro_trajectory (Trajectory.load_snaps refuses a .gro, as
    in the JAX package), each held to its format's precision;
    SnapshotViewer.load_trajectory and frame_at_time on the DCD."""
    import tempfile

    from molchanica_tpu_torch.io.gro import read_gro_trajectory
    from molchanica_tpu_torch.md.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from molchanica_tpu_torch.md.dynamics import launch_md
    from molchanica_tpu_torch.md.trajectory import FrameSlice, Trajectory
    from molchanica_tpu_torch.ops.direct_force import DirectForce
    from molchanica_tpu_torch.md.viewer import SnapshotViewer

    def host_state():
        s = md.state
        return dict(positions=s.positions.cpu().clone(),
                    velocities=s.velocities.cpu().clone(),
                    box=s.box.cpu().clone(), couple=s.couple.cpu().clone(),
                    step=s.step, generator=s.generator.get_state().clone())

    def equal(a, b):
        return {k: (a[k] == b[k]) if k == "step" else
                bool(torch.equal(a[k], b[k])) for k in a}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "o.npz")
        t0 = time.perf_counter()
        save_checkpoint(ck, md, extra={"phase": "P"})
        save_s = time.perf_counter() - t0
        saved = host_state()
        md.step(0.002, N_CKPT_STEPS)
        first = host_state()
        t0 = time.perf_counter()
        load_checkpoint(ck, md)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = equal(host_state(), saved)
        md.step(0.002, N_CKPT_STEPS)
        second = host_state()
        dx = float((first["positions"] - second["positions"]).abs().max())
        dv = float((first["velocities"] - second["velocities"]).abs().max())
        bitwise = all(equal(first, second).values())
        say(f"[P] checkpoint of O's state ({os.path.getsize(ck)} bytes, "
            f"save {save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms): "
            f"restored equal to saved {same}; two {N_CKPT_STEPS}-step "
            f"continuations: max|dx| {dx:.3e} A, max|dv| {dv:.3e} A/ps, "
            f"bitwise {bitwise} (the gate)")
        if not all(same.values()):
            raise SystemExit(f"checkpoint restore differs: {same}")
        if not bitwise:
            raise SystemExit(f"checkpoint continuations part by {dx} A")
        out.update(ckpt_bytes=os.path.getsize(ck), ckpt_dx=dx, ckpt_dv=dv,
                   ckpt_bitwise=bitwise)

        # launch_md: the same sim stepped from a background thread
        n0, k0, s0 = md.step_count, DirectForce.launches, len(md.snapshots)
        t0 = time.perf_counter()
        handle = launch_md(md, 0.002, N_CKPT_STEPS, N_CKPT_STEPS // 2)
        handle.join(timeout=300)
        torch.cuda.synchronize()
        say(f"[P] launch_md({N_CKPT_STEPS} steps) joined in "
            f"{time.perf_counter() - t0:.2f} s: running {handle.running}, "
            f"steps {md.step_count - n0}, snapshots {len(md.snapshots) - s0}"
            f", K2 launches in the thread {DirectForce.launches - k0}")
        if handle.running or md.step_count != n0 + N_CKPT_STEPS \
                or len(md.snapshots) != s0 + 2 or DirectForce.launches == k0:
            raise SystemExit("launch_md on the card")

        snaps = sim_n.snapshots
        traj = Trajectory.from_memory(snaps)
        want = np.stack([Trajectory._frame_coords(s) for s in snaps])
        n_w = 0 if snaps[0].water_o_posits is None else \
            len(snaps[0].water_o_posits)
        elements = list(mol.elements) + ["O", "H", "H"] * n_w
        eps32 = float(np.finfo(np.float32).eps)
        x_max = float(np.abs(want).max())
        # GRO rounds the float32 quotient x / 10 (nm) to 3 decimals
        tols = {"dcd": 0.0, "trr": 2.0 * eps32 * x_max,
                "xtc": 10.0 * 0.5 / XTC_PRECISION + 1e-6,
                "gro": 10.0 * 0.5e-3 + 2.0 * eps32 * x_max}
        dt_snap = snaps[1].time - snaps[0].time
        for fmt, tol in tols.items():
            path = os.path.join(tmp, f"n.{fmt}")
            t0 = time.perf_counter()
            if fmt == "gro":
                traj.save_gro(path, elements)
            elif fmt == "xtc":
                traj.save_xtc(path, precision=XTC_PRECISION)
            else:
                getattr(traj, f"save_{fmt}")(path)
            write_s = time.perf_counter() - t0
            reopened = Trajectory.open(path)
            if fmt == "gro":
                # as in the JAX package, Trajectory counts a .gro's frames
                # and its load_snaps refuses them
                frames, boxes = read_gro_trajectory(path)
                got, got_box = frames[1:], boxes[1:]
            else:
                back = reopened.load_snaps(FrameSlice(start=1))
                got = np.stack([s.atom_posits for s in back])
                got_box = np.stack([s.box_extent for s in back])
            err = float(np.abs(got - want[1:]).max()) \
                if got.shape == want[1:].shape else float("inf")
            box_err = float(np.abs(got_box - snaps[0].box_extent).max())
            say(f"[P] {fmt}: {reopened.n_frames} frames, {len(got)} read "
                f"from the second on, of {want.shape[1]} sites "
                f"({os.path.getsize(path)} bytes, written in "
                f"{write_s * 1e3:.1f} ms), max|dx| {err:.3e} A (limit "
                f"{tol:.3e}), box {box_err:.1e}")
            if reopened.n_frames != len(snaps) or len(got) != len(snaps) - 1 \
                    or not err <= tol or not box_err <= max(tol, 1e-4):
                raise SystemExit(f"{fmt} read back: {len(got)} frames, "
                                 f"max|dx| {err}, box {box_err}")
            out[f"{fmt}_err"] = err
        viewer = SnapshotViewer().load_trajectory(
            os.path.join(tmp, "n.dcd"), dt_ps=dt_snap)
        hits = [viewer.frame_at_time(s.time - snaps[0].time + 0.3 * dt_snap)
                for s in snaps]
        say(f"[P] SnapshotViewer: {len(viewer.snapshots)} frames from the "
            f"DCD, frame_at_time of each snapshot's time: {hits}")
        if len(viewer.snapshots) != len(snaps) \
                or hits != list(range(len(snaps))) \
                or not np.array_equal(viewer.get_active_snap().atom_posits,
                                      want[0]):
            raise SystemExit("SnapshotViewer on the DCD")
    return out


def screening_library():
    """The committed therapeutic CSVs' unique SMILES, sorted."""
    import csv
    import glob

    smiles = set()
    for path in sorted(glob.glob(SCREEN_CSV_GLOB)):
        with open(path) as fh:
            smiles.update(row["smiles"] for row in csv.DictReader(fh))
    return sorted(smiles)


def conformer_force(prep, coords, device, torch):
    """The vacuum force [n, 3] (on the CPU), energy and sum of |terms| of
    one conformer (its real rows, numpy) as generate_conformers' FIRE sees
    them on `device`."""
    from molchanica_tpu_torch.md.energy import make_force_fn
    from molchanica_tpu_torch.molecules.conformers import (TERM_KEYS,
                                                           _padded,
                                                           vacuum_energy_fn)

    e_fn, couple, n_pad = vacuum_energy_fn(prep, device)
    f, (e, terms) = make_force_fn(e_fn)(
        _padded(coords.astype("float32"), n_pad, couple.dtype, device),
        None, couple)
    scale = sum(abs(float(terms[k])) for k in TERM_KEYS)
    return f[:prep.n_atoms].cpu(), float(e), scale


def screening_phase(torch, np):
    """Phase Q: screen_ligs(auto_pharmacophore(ibuprofen), library_dir) on
    the card over the committed library, its CPU twin on the first
    N_SCREEN_CPU ligands, and generate_conformers' defaults with FIRE on
    the library's largest molecule and the most flexible of the rest.
    Returns (results, the hits, the library's molecules by name, the
    pharmacophore's ligand, the from_smiles molecules by SMILES)."""
    import dataclasses
    import tempfile

    from molchanica_tpu_torch.io import open_file, write_sdf
    from molchanica_tpu_torch.molecules.conformers import (
        conformer_energies, generate_conformers, prepare_conformers)
    from molchanica_tpu_torch.molecules.smiles import from_smiles
    from molchanica_tpu_torch.screening import auto_pharmacophore, screen_ligs
    from molchanica_tpu_torch.screening.screen import _iter_ligands

    out = {}
    library = screening_library()
    t0 = time.perf_counter()
    mols = [from_smiles(s) for s in library]
    out["from_smiles_s"] = time.perf_counter() - t0
    template = open_file(POCKET_SDF)
    ph = auto_pharmacophore(template)
    say(f"[Q] library: {len(library)} unique SMILES of the committed CSVs, "
        f"from_smiles {out['from_smiles_s']:.2f} s, {min(m.n_atoms for m in mols)}-"
        f"{max(m.n_atoms for m in mols)} atoms; {ph.summary()}")
    if len(ph.features) != 6:
        raise SystemExit(f"auto_pharmacophore: {len(ph.features)} features")
    with tempfile.TemporaryDirectory() as tmp:
        for k, m in enumerate(mols):
            write_sdf(m, os.path.join(tmp, f"lig{k:03d}.sdf"))
        ligs = _iter_ligands(tmp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hits = screen_ligs(ph, tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    fallback = sorted(h.name for h in hits if h.fallback)
    by_name = {m.name: m for m in ligs}
    # the CPU port's host preparation of every ligand: the ligands it
    # falls back on
    cpu_fallback = []
    for m in ligs:
        try:
            prepare_conformers(m, n_conformers=8)
        except Exception:
            cpu_fallback.append(m.name)
    out.update(ligands=len(hits), read=len(ligs), wall_s=wall,
               ligands_per_s=len(hits) / wall,
               ms_per_ligand=wall / len(hits) * 1e3, peak_gib=peak,
               fallback=fallback, top=[(h.name, h.score, h.conformer)
                                       for h in hits[:5]])
    say(f"[Q] screen_ligs over the directory on the card: {len(hits)} hits "
        f"of {len(ligs)} ligands read in {wall:.2f} s = "
        f"{out['ligands_per_s']:.2f} ligands/s, "
        f"{out['ms_per_ligand']:.2f} ms/ligand, peak {peak:.3f} GiB; "
        f"fallback {fallback} (CPU port's {sorted(cpu_fallback)}); top "
        + ", ".join(f"{h.name} {h.score:.4f} (conformer {h.conformer})"
                    for h in hits[:3]))
    if len(ligs) != len(library) or len(hits) != len(library) \
            or fallback != sorted(cpu_fallback):
        raise SystemExit(f"phase Q: {len(ligs)} read, {len(hits)} hits, "
                         f"fallback {fallback} vs {cpu_fallback}")

    # the card against the CPU port on the first ligands
    first = ligs[:N_SCREEN_CPU]
    t0 = time.perf_counter()
    cpu_hits = {h.name: h for h in screen_ligs(ph, first, device="cpu")}
    cpu_s = time.perf_counter() - t0
    card_hits = {h.name: h for h in hits}
    worst_score, worst_e, swaps = 0.0, 0.0, 0
    for m in first:
        g, c = card_hits[m.name], cpu_hits[m.name]
        worst_score = max(worst_score, abs(g.score - c.score))
        if g.fallback or c.fallback:
            if g.fallback != c.fallback or g.conformer != c.conformer:
                raise SystemExit(f"{m.name}: fallback {g} vs {c}")
            continue
        prep = prepare_conformers(m, n_conformers=8)
        e_g, t_g = conformer_energies(prep, torch.device("cuda"))
        e_c, t_c = conformer_energies(prep, torch.device("cpu"))
        scale = sum(v.abs() for v in t_c.values())
        err = ((e_g.cpu() - e_c).abs() / scale).max()
        worst_e = max(worst_e, float(err))
        cs_g = generate_conformers(m, n_conformers=8)
        cs_c = generate_conformers(m, n_conformers=8, device="cpu")
        rows_g = cs_g.coords.reshape(len(cs_g.coords), -1)
        rows_c = cs_c.coords.reshape(len(cs_c.coords), -1)
        same = np.array_equal(rows_g[np.lexsort(rows_g.T[::-1])],
                              rows_c[np.lexsort(rows_c.T[::-1])])
        if not same or float(err) > SCREEN_ENERGY_TOL:
            raise SystemExit(f"{m.name}: conformers equal {same}, energy "
                             f"err {float(err):.3e} of sum|terms|")
        if g.conformer != c.conformer:
            # the same candidate, ranked apart by energies within the gate
            lo, hi = sorted((g.conformer, c.conformer))
            gap = float(cs_g.energies[hi] - cs_g.energies[lo])
            tol = 2.0 * SCREEN_ENERGY_TOL * float(scale.max())
            swaps += 1
            if not np.array_equal(cs_g.coords[g.conformer],
                                  cs_c.coords[c.conformer]) or gap > tol:
                raise SystemExit(f"{m.name}: conformer {g.conformer} vs "
                                 f"{c.conformer}, energy gap {gap} > {tol}")
    out.update(cpu_ligands=len(first), cpu_s=cpu_s,
               max_score_err=worst_score, max_energy_err=worst_e,
               conformer_swaps=swaps)
    say(f"[Q] first {len(first)} ligands on the CPU port in {cpu_s:.2f} s: "
        f"max|d score| {worst_score:.3e} (limit {SCREEN_SCORE_TOL:g}), "
        f"energies max {worst_e:.3e} of sum|terms| (limit "
        f"{SCREEN_ENERGY_TOL:g}), conformer candidates bit for bit, "
        f"{swaps} best-conformer indices apart within the energy gate")
    if worst_score > SCREEN_SCORE_TOL:
        raise SystemExit(f"screen scores card vs CPU {worst_score}")

    # one conformer batch of the median ligand under the profiler
    typical = sorted(ligs, key=lambda m: m.n_atoms)[len(ligs) // 2]
    prep = prepare_conformers(typical, n_conformers=8)
    conformer_energies(prep, torch.device("cuda"))
    _, _, _, dev_ms, kernels, wall_ms = profile_calls(
        lambda: conformer_energies(prep, torch.device("cuda")), torch)
    out.update(batch_atoms=typical.n_atoms, batch_device_ms=dev_ms,
               batch_kernels=kernels, batch_wall_ms=wall_ms,
               batch_busy=dev_ms / wall_ms)
    say(f"[Q] one batch of 8 conformers ({typical.name}, {typical.n_atoms} "
        f"atoms, {prep.topology.n_atoms} padded): device {dev_ms:.3f} ms "
        f"in {kernels} kernels, wall {wall_ms:.3f} ms, busy "
        f"{100.0 * dev_ms / wall_ms:.1f}%")

    # generate_conformers' defaults (32, FIRE on the best)
    torsions = {m.name: len(prepare_conformers(m, n_conformers=1).torsions)
                for m in ligs if m.name not in fallback}
    # the largest molecule is also the most flexible (14 torsions), so the
    # second is the most flexible of the rest
    largest = max(ligs, key=lambda m: m.n_atoms)
    flexible = max((m for m in ligs if m.name in torsions
                    and m is not largest), key=lambda m: torsions[m.name])
    out["minimized"] = []
    for tag, m in (("largest", largest), ("next most flexible", flexible)):
        prep = prepare_conformers(m)
        cs0 = generate_conformers(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs = generate_conformers(m, minimize_best=True)
        torch.cuda.synchronize()
        fire_s = time.perf_counter() - t0
        # at FIRE's final state the force (~1 kcal/mol/A) is a sum of
        # bonded and pair forces of ~100 whose float32 roundoff is ~1e-4:
        # there the card's float32 force is held to the CPU's float64 force
        # within CONF_TOL_F of max|F| plus CONF_FLOORS x the CPU's own
        # float32 error against it
        prep64 = dataclasses.replace(prep,
                                     cfg=prep.cfg.replace(dtype="float64"))
        f_g, e_g, scale = conformer_force(prep, cs.coords[0], "cuda", torch)
        f_c, e_c, _ = conformer_force(prep, cs.coords[0], "cpu", torch)
        f_64, _, _ = conformer_force(prep64, cs.coords[0], "cpu", torch)
        err = float((f_g - f_c).abs().max())
        err64 = float((f_g.double() - f_64).abs().max())
        floor = float((f_c.double() - f_64).abs().max())
        f_max = float(f_64.abs().max())
        lim = CONF_TOL_F * f_max + CONF_FLOORS * floor
        e0, e1 = float(cs0.energies[0]), float(cs.energies[0])
        finite = bool(np.isfinite(cs.coords).all()
                      and np.isfinite(cs.energies).all())
        say(f"[Q] {tag}: {m.name} ({m.n_atoms} atoms, {torsions[m.name]} "
            f"torsions), 32 conformers + FIRE 200 in {fire_s:.2f} s: best "
            f"{e0:.4f} -> {e1:.4f} kcal/mol; force at the card's final "
            f"state card vs CPU float32 max|dF| {err:.3e}, vs CPU float64 "
            f"{err64:.3e} against {lim:.3e} (1e-4 of max|F| {f_max:.3e} + "
            f"{CONF_FLOORS:g} x the CPU's float32 error {floor:.3e}; "
            f"card over CPU error {err64 / floor:.2f})")
        if not finite or e1 > e0 + SCREEN_ENERGY_TOL * scale \
                or not err64 <= lim:
            raise SystemExit(f"minimize_best on {m.name}: finite={finite} "
                             f"{e0} -> {e1}, max|dF| {err64} against {lim}")
        out["minimized"].append(dict(
            name=m.name, atoms=m.n_atoms, torsions=torsions[m.name],
            fire_s=fire_s, e_best=e0, e_min=e1, max_df=err,
            max_df_f64=err64, f32_floor=floor, max_f=f_max))
    return out, hits, by_name, template, dict(zip(library, mols))


def align_hit(hits, template):
    """The best hit that is typed (not a fallback) and is not the
    pharmacophore's own ligand: the library holds ibuprofen, whose rigid
    prealignment onto the template is already exact, so the flexible
    stage has nothing to improve there."""
    from molchanica_tpu_torch.molecules.smiles import to_smiles

    own = to_smiles(template)
    return next(h for h in hits if not h.fallback
                and h.name not in (own, template.name))


def hbond_inputs(sim, mol, np):
    """Elements, positions, bonds and box of an MdSim's last snapshot of
    the ligand in water (its M sites left out, as the writers do)."""
    from molchanica_tpu_torch.md.trajectory import Trajectory

    snap = sim.snapshots[-1]
    x = Trajectory._frame_coords(snap)
    n_w = 0 if snap.water_o_posits is None else len(snap.water_o_posits)
    n = mol.n_atoms
    elements = list(mol.elements) + ["O", "H", "H"] * n_w
    bonds = list(mol.bonds) + [(n + 3 * k, n + 3 * k + h)
                               for k in range(n_w) for h in (1, 2)]
    return dict(elements=elements, positions=np.asarray(x, float),
                bonds=bonds, box=np.asarray(snap.box_extent, float),
                time=snap.time)


def alignment_tools_phase(hit, template, hb, asys, cfg, mol_n, torch, np):
    """Phase R: flexible_align of the top hit onto the pharmacophore's
    ligand at its defaults (FIRE 200 at construction, 400 steps of 1 fs,
    k_pull 10) on the card, the matched-pair RMSD after the pulled steps
    below its value after FIRE; its force with the pull on the card against
    the CPU at the rigid prealignment, and the pull alone, on the card,
    against float64 from the template and the matched pairs, at the
    prealignment and at the end of the pulled steps; find_hydrogen_bonds
    on phase N's
    last snapshot with its box; make_gromacs_input of N's assembled
    system read back through read_gro."""
    import tempfile

    from molchanica_tpu_torch.analysis import find_hydrogen_bonds
    from molchanica_tpu_torch.io.gro import read_gro
    from molchanica_tpu_torch.io.gromacs import make_gromacs_input
    from molchanica_tpu_torch.md import engine
    from molchanica_tpu_torch.molecules.alignment import (alignment_sim,
                                                          flexible_align,
                                                          rigid_align)

    out = {}
    k_pull = inspect.signature(flexible_align).parameters["k_pull"].default
    x_t = np.asarray(template.positions, float)

    def pull_err(sim, pairs):
        """The sim's pull at its state against -k_pull (x_i - t_j) in
        float64 over the matched pairs (zero elsewhere), and its limit."""
        if not pairs:
            return 0.0, 0.0, 0.0
        x = sim.state.positions
        with torch.no_grad():
            f_p = sim.external_forces_fn(x).double().cpu().numpy()
        x = x.double().cpu().numpy()
        want = np.zeros_like(x)
        ia = [p[0] for p in pairs]
        ib = [p[1] for p in pairs]
        want[ia] = -k_pull * (x[ia] - x_t[ib])
        eps32 = float(np.finfo(np.float32).eps)
        lim = PULL_ULPS * eps32 * k_pull * (
            float(np.abs(x_t[ib]).max()) + float(np.abs(want).max()) / k_pull)
        return float(np.abs(f_p - want).max()), lim, float(
            np.abs(want).max())

    # the card's force, pull included, against the CPU's at the prealigned
    # state (one clash there makes max|F| ~1e4); the pull alone, card
    # against CPU and against float64, in units of its own size
    sims = {}
    for d in ("cuda", "cpu"):
        sims[d], _, pairs = alignment_sim(hit, template, device=d,
                                          relax=False)
    x_c = sims["cpu"].state.positions
    f, f_pull = {}, {}
    for d, sim in sims.items():
        x = x_c.to(sim.device)
        s = sim.state
        with torch.no_grad():
            f_pull[d] = sim.external_forces_fn(x)
            f_d = sim.force_fn(x, s.box, s.couple)[0] + f_pull[d]
        f[d] = f_d[:hit.n_atoms].cpu()
        f_pull[d] = f_pull[d].cpu()
    err = float((f["cuda"] - f["cpu"]).abs().max())
    f_max = float(f["cpu"].abs().max())
    err_pull_cpu = float((f_pull["cuda"] - f_pull["cpu"]).abs().max())
    err_pull0, lim_pull0, pull_max0 = pull_err(sims["cuda"], pairs)
    del sims

    timing = dict(steps=0, step_s=0.0)

    class Timed(engine.MdSim):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._outer = True
            timing["fire_s"] = self.relax_log["seconds"]
            timing["x_fire"] = self.state.positions[:hit.n_atoms].cpu()
            timing["sim"] = self

        def step(self, dt_ps, n_steps=1, *a, **kw):
            # the caller's call only (a long call steps itself in chunks)
            outer, self._outer = self._outer, False
            t0 = time.perf_counter()
            try:
                return super().step(dt_ps, n_steps, *a, **kw)
            finally:
                self._outer = outer
                if outer:
                    torch.cuda.synchronize()
                    timing["step_s"] += time.perf_counter() - t0
                    timing["steps"] += n_steps

    base, engine.MdSim = engine.MdSim, Timed
    try:
        t0 = time.perf_counter()
        res = flexible_align(hit, template)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.MdSim = base
    err_pull1, lim_pull1, pull_max1 = pull_err(timing.pop("sim"),
                                               res.matched_pairs)
    rigid = rigid_align(hit, template)
    ia = [p[0] for p in res.matched_pairs]
    ib = [p[1] for p in res.matched_pairs]
    rmsd_fire = float(np.sqrt(((timing["x_fire"].double().numpy()[ia]
                                - x_t[ib]) ** 2).sum(1).mean()))
    finite = bool(np.isfinite(res.positions).all())
    ms_step = timing["step_s"] / timing["steps"] * 1e3
    out.update(align_wall_s=wall, align_fire_s=timing["fire_s"],
               align_ms_per_step=ms_step, rmsd=res.rmsd,
               rigid_rmsd=rigid.rmsd, fire_rmsd=rmsd_fire,
               pairs=len(res.matched_pairs), align_max_df=err,
               align_max_f=f_max, pull_card_cpu=err_pull_cpu,
               pull_err_prealigned=err_pull0, pull_lim_prealigned=lim_pull0,
               pull_max_prealigned=pull_max0, pull_err_final=err_pull1,
               pull_lim_final=lim_pull1, pull_max_final=pull_max1)
    say(f"[R] flexible_align({hit.name} onto {template.name}): "
        f"{len(res.matched_pairs)} matched pairs, RMSD rigid "
        f"{rigid.rmsd:.4f}, after FIRE {rmsd_fire:.4f}, after the pulled "
        f"steps {res.rmsd:.4f} A; FIRE {timing['fire_s']:.2f} s, "
        f"{timing['steps']} steps at {ms_step:.3f} ms/step, wall "
        f"{wall:.2f} s; force with the pull card vs CPU at the prealigned "
        f"state max|dF| {err:.3e} (max|F| {f_max:.3e}); the pull alone "
        f"card vs CPU {err_pull_cpu:.3e}, card vs float64 at the "
        f"prealigned state {err_pull0:.3e} (max {pull_max0:.3e}, limit "
        f"{lim_pull0:.3e}), after the pulled steps {err_pull1:.3e} (max "
        f"{pull_max1:.3e}, limit {lim_pull1:.3e})")
    # FIRE at construction runs without the pull and moves the molecule
    # off its rigid prealignment, as in the reference (ROADMAP Queue 3):
    # the pulled steps are held to bring it back toward the template
    if not finite or not res.rmsd < rmsd_fire or len(ia) < 3 \
            or not err <= CONF_TOL_F * f_max \
            or not err_pull_cpu <= lim_pull0 or not err_pull0 <= lim_pull0 \
            or not err_pull1 <= lim_pull1:
        raise SystemExit(f"flexible_align: finite={finite} rmsd "
                         f"{res.rmsd} vs {rmsd_fire} after FIRE, pairs "
                         f"{len(ia)}, max|dF| {err}; pull card vs CPU "
                         f"{err_pull_cpu}, vs float64 {err_pull0} and "
                         f"{err_pull1} against {lim_pull0} and {lim_pull1}")

    t0 = time.perf_counter()
    bonds_h = find_hydrogen_bonds(hb["elements"], hb["positions"],
                                  hb["bonds"], box=hb["box"])
    hb_ms = (time.perf_counter() - t0) * 1e3
    d_max = max((h.distance for h in bonds_h), default=float("nan"))
    a_min = min((np.degrees(h.angle) for h in bonds_h), default=float("nan"))
    n_lig = sum(1 for h in bonds_h if h.donor < mol_n.n_atoms
                or h.acceptor < mol_n.n_atoms)
    out.update(hbonds=len(bonds_h), hbonds_ligand=n_lig, hbond_ms=hb_ms,
               hbond_max_da=d_max, hbond_min_angle=a_min)
    say(f"[R] find_hydrogen_bonds on N's last snapshot (t = "
        f"{hb['time']:.3f} ps, {len(hb['elements'])} sites, box): "
        f"{len(bonds_h)} H-bonds ({n_lig} with the ligand) in {hb_ms:.1f} "
        f"ms, D-A <= {d_max:.3f} A, angle >= {a_min:.2f} deg")
    if not bonds_h or not d_max <= 3.5 or not a_min >= 120.0:
        raise SystemExit(f"H-bonds: {len(bonds_h)}, D-A {d_max}, angle "
                         f"{a_min}")

    n_real = asys.topology.n_atoms_real
    sc = 0 if asys.water_model is None else asys.water_model.site_count
    elements = list(mol_n.elements) + (["O", "H", "H", "M"][:sc]
                                       * asys.n_waters)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mdp = make_gromacs_input(asys, cfg, 1000, 0.002, tmp,
                                 elements=elements)
        gmx_ms = (time.perf_counter() - t0) * 1e3
        back, box = read_gro(os.path.join(tmp, "md.gro"))
        top_text = open(os.path.join(tmp, "md.top")).read()
        mdp_text = mdp.read_text()
    want = np.asarray(asys.positions, float)[:n_real]
    eps32 = float(np.finfo(np.float32).eps)
    tol = 10.0 * 0.5e-3 + 2.0 * eps32 * float(np.abs(want).max())
    err_gro = float(np.abs(np.asarray(back.positions) - want).max()) \
        if back.n_atoms == n_real else float("inf")
    mols_sec = top_text.split("[ molecules ]")[-1].split()
    counts = dict(zip(mols_sec[::2], (int(v) for v in mols_sec[1::2])))
    want_counts = {"MOL": 1, **({"SOL": asys.n_waters} if asys.n_waters
                                else {})}
    out.update(gromacs_ms=gmx_ms, gro_err=err_gro, top_counts=counts)
    say(f"[R] make_gromacs_input of N's system in {gmx_ms:.1f} ms: .gro "
        f"of {back.n_atoms} sites read back max|dx| {err_gro:.3e} A (limit "
        f"{tol:.3e}), box {[round(float(v), 3) for v in box]}, .top "
        f"[ molecules ] {counts}, .mdp integrator "
        f"{mdp_text.split()[2]}")
    if not err_gro <= tol or counts != want_counts:
        raise SystemExit(f"GROMACS export: max|dx| {err_gro}, molecules "
                         f"{counts} vs {want_counts}")
    return out


def adme_phase(mols_by_smiles, torch, np):
    """Phase S: every committed ADME weights file through the JAX-free
    loader, TherapeuticPredictor.predict_mols on the card over the library
    (Q's parsed molecules), each raw output against the port on the CPU,
    compute_therapeutic_properties card vs CPU, the measured orderings."""
    import glob

    from molchanica_tpu_torch.models.adme import (adme_forward, build_model,
                                                  featurize_batch,
                                                  postprocess)
    from molchanica_tpu_torch.therapeutic.infer import (
        REFERENCE_WEIGHTS_DIR, TherapeuticPredictor,
        compute_therapeutic_properties)

    library = sorted(mols_by_smiles)
    mols = [mols_by_smiles[s] for s in library]
    paths = sorted(glob.glob(os.path.join(REFERENCE_WEIGHTS_DIR, "*.pkl")))
    if len(paths) != 27:
        raise SystemExit(f"phase S: {len(paths)} committed weights files")
    t0 = time.perf_counter()
    feats = featurize_batch(mols)
    feat_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, worst = [], 0.0
    for path in paths:
        t0 = time.perf_counter()
        pred = TherapeuticPredictor(os.path.basename(path)[:-4],
                                    weights_path=path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        vals = pred.predict_mols(mols)
        target_ms = (time.perf_counter() - t0) * 1e3
        raw = pred.raw_feats(feats)
        raw_c = adme_forward(build_model(pred.cfg, pred.model.state_dict(),
                                         "cpu"), feats)
        err = float((np.abs(raw.astype(np.float64) - raw_c)
                     / (1.0 + np.abs(raw_c))).max())
        worst = max(worst, err)
        same = np.array_equal(vals, postprocess(raw, pred.scaler, pred.cfg))
        finite = bool(np.isfinite(vals).all())
        rows.append(dict(target=pred.target, load_ms=load_ms,
                         ms=target_ms, err=err,
                         classification=pred.cfg.classification))
        if not (err <= ADME_TOL and same and finite
                and vals.shape == (len(mols),)):
            raise SystemExit(f"phase S {pred.target}: raw card vs CPU "
                             f"{err:.3e} of 1 + |raw|, predict_mols equal "
                             f"to the raw path {same}, finite {finite}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = np.array([r["ms"] for r in rows])
    load = np.array([r["load_ms"] for r in rows])
    # one forward under the profiler (the last target): its kernels, and
    # apart from them the batch's copies to the card
    prof = profile_kernels(lambda: pred.raw_feats(feats), torch)
    dev_ms, kernels, wall_ms = (prof["kernel_ms"], prof["kernels"],
                                prof["wall_ms"])
    out = dict(targets=len(rows), molecules=len(mols), featurize_s=feat_s,
               load_ms_mean=float(load.mean()), load_ms_max=float(load.max()),
               ms_per_target_mean=float(ms.mean()),
               ms_per_target_max=float(ms.max()),
               molecules_per_s=len(mols) / float(ms.mean()) * 1e3,
               max_raw_err=worst, forward_device_ms=dev_ms,
               forward_kernels=kernels, forward_copy_ms=prof["copy_ms"],
               forward_copies=prof["copies"], forward_wall_ms=wall_ms,
               forward_busy=dev_ms / wall_ms, peak_gib=peak)
    say(f"[S] {len(rows)} committed weights files through the JAX-free "
        f"loader: load {load.mean():.2f} ms per file (max {load.max():.2f}); "
        f"featurize_batch of {len(mols)} molecules {feat_s:.3f} s (host, "
        f"paid again inside each predict_mols); predict_mols on the card "
        f"{ms.mean():.1f} ms per target (max {ms.max():.1f}) = "
        f"{out['molecules_per_s']:.0f} molecules/s; raw outputs card vs CPU "
        f"max {worst:.3e} of 1 + |raw| (limit {ADME_TOL:g}); one forward "
        f"of {len(mols)}: {dev_ms:.3f} ms of device time in {kernels} "
        f"kernels, besides {prof['copy_ms']:.3f} ms in {prof['copies']} "
        f"copies and fills, wall {wall_ms:.3f} ms, kernels busy "
        f"{100.0 * dev_ms / wall_ms:.1f}%; peak "
        f"{peak:.3f} GiB")

    # grouped properties on the first SMILES, card vs CPU
    smiles = library[:N_PROPS_SMILES]
    t0 = time.perf_counter()
    props_g = compute_therapeutic_properties(smiles)
    props_s = time.perf_counter() - t0
    props_c = compute_therapeutic_properties(smiles, device="cpu")
    worst_p, nan_fields = 0.0, set()
    for g, c in zip(props_g, props_c):
        for group, vals in c.as_dict().items():
            for k, v in vals.items():
                u = g.as_dict()[group][k]
                if np.isnan(u) != np.isnan(v):
                    raise SystemExit(f"phase S: {group}.{k} NaN on one side")
                if np.isnan(v):
                    nan_fields.add(f"{group}.{k}")
                else:
                    worst_p = max(worst_p, abs(u - v) / (1.0 + abs(v)))
    out.update(props_s=props_s, props_err=worst_p,
               props_nan=sorted(nan_fields))
    say(f"[S] compute_therapeutic_properties of {len(smiles)} SMILES on "
        f"the card in {props_s:.2f} s: card vs CPU max {worst_p:.3e} of "
        f"1 + |v|, NaN fields {sorted(nan_fields)} on both")
    if worst_p > ADME_TOL:
        raise SystemExit(f"phase S: properties card vs CPU {worst_p}")

    for target, hi, lo, gap in ORDERINGS:
        p = TherapeuticPredictor(target).predict([hi, lo])
        out[f"{target}_pair"] = [float(v) for v in p]
        say(f"[S] {target}: {hi} {p[0]:.4f} vs {lo} {p[1]:.4f} (must lead "
            f"by more than {gap:g})")
        if not p[0] > p[1] + gap:
            raise SystemExit(f"phase S: {target} ordering {p}")
    return out


def package_listing(top):
    """{path: (size, mtime_ns)} of every file under top."""
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def train_phase(mols_by_smiles, torch, np):
    """Phase T: train_target(TRAIN_TARGET) at the reference's defaults on
    the card and on the CPU port into temporary directories; the saved
    file reloaded; nothing under molchanica_tpu/ written."""
    import tempfile

    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)

    from molchanica_tpu_torch.models.eval import pearson
    from molchanica_tpu_torch.therapeutic.data import (load_csv_dataset,
                                                       split_dataset)
    from molchanica_tpu_torch.therapeutic.infer import TherapeuticPredictor
    from molchanica_tpu_torch.therapeutic.targets import (EXPERIMENTAL_DATA,
                                                          REFERENCE_DIR)
    from molchanica_tpu_torch.therapeutic.train import train_target

    pkg = os.path.join(ROOT, "molchanica_tpu")
    before = package_listing(pkg)
    # the optimizer steps of each run: their count and the host time from
    # the first step's start to the last step's end (train_adme reads each
    # epoch's val loss, so the card is never more than an epoch behind)
    steps = []
    pre = register_optimizer_step_pre_hook(
        lambda opt, a, k: steps.append([time.perf_counter(), None]))
    post = register_optimizer_step_post_hook(
        lambda opt, a, k: steps[-1].__setitem__(1, time.perf_counter()))
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for dev in ("cuda", "cpu"):
                steps.clear()
                wdir = os.path.join(tmp, dev)
                t0 = time.perf_counter()
                res = train_target(TRAIN_TARGET, weights_dir=wdir,
                                   device=dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                step_ms = (steps[-1][1] - steps[0][0]) / len(steps) * 1e3
                runs[dev] = (res, wall, len(steps), step_ms)
            res_g = runs["cuda"][0]
            smiles, y = load_csv_dataset(os.path.join(
                REFERENCE_DIR, EXPERIMENTAL_DATA[TRAIN_TARGET]))
            _, _, te = split_dataset(len(smiles), seed=0)
            test_mols = [mols_by_smiles[smiles[i]] for i in te]
            reloaded = TherapeuticPredictor(
                TRAIN_TARGET, weights_path=res_g["weights_path"]
            ).predict_mols(test_mols)
    finally:
        pre.remove()
        post.remove()
    after = package_listing(pkg)
    h_g = np.asarray(runs["cuda"][0]["history"])[:TRAIN_EPOCHS_HELD, 1:]
    h_c = np.asarray(runs["cpu"][0]["history"])[:TRAIN_EPOCHS_HELD, 1:]
    loss_err = float((np.abs(h_g - h_c) / np.abs(h_c)).max())
    bitwise = np.array_equal(reloaded, res_g["test_pred"])
    r_test = pearson(y[te], reloaded)
    out = {}
    for dev, (res, wall, n, step_ms) in runs.items():
        out[dev] = dict(train_s=wall, steps=n, ms_per_step=step_ms,
                        metrics=res["metrics"], n_train=res["n_train"],
                        n_test=res["n_test"],
                        history_tail=res["history_tail"])
        say(f"[T] train_target({TRAIN_TARGET!r}) on {dev}: {wall:.2f} s, "
            f"{n} optimizer steps at {step_ms:.3f} ms per step; n_train "
            f"{res['n_train']}, n_test {res['n_test']}, held-out pearson "
            f"{res['metrics']['pearson']:.4f} rmse "
            f"{res['metrics']['rmse']:.4f}; last epoch loss "
            f"{res['history'][-1][1]:.5f} val {res['history'][-1][2]:.5f}")
    out.update(loss_err=loss_err, reloaded_bitwise=bitwise,
               reloaded_pearson=r_test,
               package_unchanged=before == after)
    say(f"[T] first {TRAIN_EPOCHS_HELD} epochs' losses card vs CPU max "
        f"{loss_err:.3e} relative (limit {TRAIN_LOSS_TOL:g}); the saved file "
        f"through TherapeuticPredictor(weights_path=...) predicts the test "
        f"set bit for bit: {bitwise} (pearson {r_test:.4f}); files under "
        f"molchanica_tpu/ unchanged: {before == after} ({len(after)} files)")
    if not (loss_err <= TRAIN_LOSS_TOL and bitwise and before == after
            and all(r[0]["metrics"]["pearson"] >= TRAIN_PEARSON_MIN
                    for r in runs.values())):
        raise SystemExit("phase T failed")
    return out


def polyalanine_backbone(np):
    """N, CA, C, O of build_polyalanine(MPNN_RESIDUES, seed=MPNN_SEED) as
    an MPNN Backbone (one chain)."""
    from molchanica_tpu_torch.systems.bench_systems import (
        _ALA_ATOMS, build_polyalanine)
    from molchanica_tpu_torch.therapeutic.mpnn import Backbone

    spec = build_polyalanine(MPNN_RESIDUES, seed=MPNN_SEED)
    names = [a[0] for a in _ALA_ATOMS]
    x = np.asarray(spec.positions).reshape(MPNN_RESIDUES, len(names), 3)
    n, ca, c, o = (x[:, names.index(a)] for a in ("N", "CA", "C", "O"))
    return Backbone(n=n, ca=ca, c=c, o=o,
                    chain_index=np.zeros(MPNN_RESIDUES, int),
                    residue_index=np.arange(MPNN_RESIDUES))


def mpnn_phase(torch, np):
    """Phase U: ProteinMPNN at full width on the card: forward against the
    CPU in float64, normalization, rigid invariance, conditional scoring,
    MPNN_SAMPLES designs against teacher forcing, ddg_scan."""
    from molchanica_tpu_torch.therapeutic import mpnn as M

    bb = polyalanine_backbone(np)
    L = len(bb)
    p_g = M.init_weights(torch.Generator().manual_seed(0))
    p_c = {k: v.cpu().double() for k, v in p_g.items()}
    out = {}
    lp_g = M.forward(p_g, bb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp_c = M.forward(p_c, bb)
    cpu_s = time.perf_counter() - t0
    prof = profile_kernels(lambda: M.forward(p_g, bb), torch)
    dev_ms, kernels, wall_ms = (prof["kernel_ms"], prof["kernels"],
                                prof["wall_ms"])
    err = float((lp_g.double().cpu() - lp_c).abs().max())
    sums = float((lp_g.double().exp().sum(-1) - 1.0).abs().max())
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    shift = np.array([11.0, -3.0, 7.0])
    moved = M.Backbone(*(a @ R.T + shift for a in (bb.n, bb.ca, bb.c, bb.o)),
                       bb.chain_index, bb.residue_index)
    rigid = float((M.forward(p_g, moved) - lp_g).abs().max())
    out.update(residues=L, forward_err=err, row_sum_err=sums,
               rigid_err=rigid, forward_device_ms=dev_ms,
               forward_kernels=kernels, forward_copies=prof["copies"],
               forward_wall_ms=wall_ms, forward_cpu_f64_s=cpu_s)
    say(f"[U] ProteinMPNN forward, {L} residues of build_polyalanine "
        f"(seed {MPNN_SEED}), K {M.K_NEIGHBORS}: device {dev_ms:.3f} ms in "
        f"{kernels} kernels (besides {prof['copies']} copies and fills), "
        f"wall {wall_ms:.3f} ms (CPU float64 "
        f"{cpu_s:.2f} s); card float32 vs CPU float64 max|d log p| "
        f"{err:.3e} (limit {MPNN_TOL:g}), rows sum to 1 within {sums:.3e} "
        f"(limit {MPNN_SUM_TOL:g}), rigid motion {rigid:.3e}")
    if not (err <= MPNN_TOL and sums <= MPNN_SUM_TOL and rigid <= MPNN_TOL):
        raise SystemExit("phase U: forward gates")

    # teacher-forced scoring of all-A under one order, card vs CPU
    seq_a = "A" * L
    t0 = time.perf_counter()
    cl_g = M.conditional_log_probs(p_g, bb, seq_a,
                                   torch.Generator().manual_seed(5))
    cond_s = time.perf_counter() - t0
    cl_c = M.conditional_log_probs(p_c, bb, seq_a,
                                   torch.Generator().manual_seed(5))
    cond_err = float(np.abs(cl_g - cl_c).max())
    # the first MPNN_PROFILE_STEPS steps of the teacher-forced decode of
    # all-A (L residues, K 48) under the profiler, the encoder apart, in
    # the order conditional_log_probs drew
    enc = M._encode(p_g, M._bb_arrays(p_g, bb), M.K_NEIGHBORS)
    order = torch.randperm(L, generator=torch.Generator().manual_seed(5))
    n_p = MPNN_PROFILE_STEPS
    c_prof = profile_kernels(
        lambda: M._decode(p_g, enc, order[:n_p].tolist(),
                          sequence=[0] * L), torch)
    c_dev_ms, c_kernels, c_wall_ms = (c_prof["kernel_ms"],
                                      c_prof["kernels"], c_prof["wall_ms"])
    out.update(conditional_err=cond_err, conditional_s=cond_s,
               decode_ms_per_step=cond_s / L * 1e3,
               decode_kernels_per_step=c_kernels / n_p,
               decode_device_ms_per_step=c_dev_ms / n_p,
               decode_busy=c_dev_ms / c_wall_ms,
               decode_profile_read_s=c_prof["read_s"])
    say(f"[U] conditional_log_probs of all-A: card vs CPU float64 max "
        f"{cond_err:.3e} (limit {MPNN_TOL:g}); {cond_s:.2f} s on the card = "
        f"{cond_s / L * 1e3:.3f} ms per decode step (the encoder "
        f"included); its first {n_p} of {L} decode steps (K "
        f"{M.K_NEIGHBORS}) profiled: {c_kernels / n_p:.1f} kernels and "
        f"{c_dev_ms / n_p:.4f} ms of device time per step, wall "
        f"{c_wall_ms / n_p:.3f} ms per step, busy "
        f"{100.0 * c_dev_ms / c_wall_ms:.1f}% ({c_prof['copies']} "
        f"copies and fills apart; the trace read in "
        f"{c_prof['read_s']:.2f} s)")
    if not cond_err <= MPNN_TOL:
        raise SystemExit(f"phase U: conditional_log_probs {cond_err}")

    # designs at MPNN_T, each against the teacher-forced decode of its
    # sequence under the same order (design_sequences' draws, replayed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, lps = M.design_sequences(p_g, bb, torch.Generator().manual_seed(7),
                                   n_samples=MPNN_SAMPLES,
                                   temperature=MPNN_T)
    design_s = (time.perf_counter() - t0) / MPNN_SAMPLES
    g = torch.Generator().manual_seed(7)
    worst = 0.0
    for s, lp in zip(seqs, lps):
        order, _ = M._draw(g, L)
        idx, rows = M._decode(p_g, enc, order.tolist(),
                              sequence=[M.ALPHABET.index(c) for c in s])
        lp20 = torch.log_softmax(rows[:, :20].double(), dim=-1)
        worst = max(worst, abs(float(lp20.gather(1, idx[:, None]).mean())
                               - float(lp)))
    has_x = any("X" in s for s in seqs)
    ddg = M.ddg_scan(lp_g, seqs[0])
    wt_zero = bool(all(ddg[i, M.ALPHABET.index(a)] == 0
                       for i, a in enumerate(seqs[0])))
    out.update(samples=MPNN_SAMPLES, s_per_design=design_s, design_err=worst,
               mean_log_probs=[float(v) for v in lps],
               identity=[float(np.mean([a == b for a, b in zip(s, seq_a)]))
                         for s in seqs])
    say(f"[U] design_sequences: {MPNN_SAMPLES} samples at T {MPNN_T:g} in "
        f"{design_s:.2f} s per sequence ({design_s / L * 1e3:.3f} ms per "
        f"step); mean log p {[round(float(v), 4) for v in lps]}; against "
        f"the teacher-forced decode of each max {worst:.3e} (limit "
        f"{MPNN_DESIGN_TOL:g}); X in a sample {has_x}; ddg_scan wild type "
        f"zero {wt_zero}; first {seqs[0][:40]}...")
    if not (worst <= MPNN_DESIGN_TOL and not has_x and wt_zero):
        raise SystemExit("phase U: design gates")
    return out


def dense_or_cluster_parity(build, tag, torch):
    """The card's force at the initial state against the CPU's: phase
    28's allpairs gate for a dense method, phase 10's gate otherwise."""
    md_g = build("cuda")
    if md_g.method.startswith("allpairs"):
        allpairs_parity(md_g, build("cpu"), md_g.method, tag, torch)
    else:
        md_engine_parity(lambda dev: md_g if dev == "cuda" else build(dev),
                         torch)


def solvated_run(tag, spec, ff_mol_type, torch, np):
    """V's and W's path for one prepared biomolecule: MolDynamics(spec=...)
    through build_dynamics at phase N's MdConfig at a pad of BIO_PAD A on
    the card (FIRE at construction), its force card vs CPU at the initial
    state (relaxation off), then run_dynamics_blocking(sim, 0.002,
    N_BIO_STEPS, N_BIO_STEPS // 4) timed between synchronizes. Gates:
    finite, 100 K < T < 600 K, rigid waters, four snapshots, the solute's
    extent below BIO_EXTENT A. Returns its numbers."""
    from molchanica_tpu_torch.md.dynamics import (MolDynamics,
                                                  build_dynamics,
                                                  run_dynamics_blocking)

    cfg = quickstart_cfg(BIO_PAD)

    def build(c, device):
        return build_dynamics([MolDynamics(ff_mol_type=ff_mol_type,
                                           spec=spec)], c, device=device)

    t0 = time.perf_counter()
    sim = build(cfg, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    a, r = sim.assembled, sim.relax_log
    box = [float(v) for v in a.box_extent]
    say(f"[{tag}] build_dynamics {build_s:.2f} s: {spec.n_atoms} solute "
        f"atoms, {a.n_waters} OPC waters, {a.topology.n_atoms_real} real "
        f"sites ({a.topology.n_atoms} padded), box {box[0]:.4f} x "
        f"{box[1]:.4f} x {box[2]:.4f} A, method {sim.method} "
        f"({sim._nbr_backend}); FIRE {r['iters']} iterations in "
        f"{r['seconds']:.2f} s ({r['path']}, kept {r['kept']}), E "
        f"{r['e_first']:.3f} -> {r['e_last']:.3f} kcal/mol")
    t0 = time.perf_counter()
    dense_or_cluster_parity(lambda dev: build(cfg.replace(
        max_init_relaxation_iters=None), dev), tag, torch)
    parity_s = time.perf_counter() - t0
    interval = max(N_BIO_STEPS // 4, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = run_dynamics_blocking(sim, 0.002, N_BIO_STEPS, interval)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ms_step = elapsed / N_BIO_STEPS * 1e3
    ns_day = N_BIO_STEPS * 0.002 / 1000.0 / elapsed * 86400.0
    t_final = sim.temperature()
    x = sim.state.positions.cpu().numpy()
    finite = bool(np.isfinite(x).all())
    extent = float(np.ptp(x[:a.n_solute_atoms], axis=0).max())
    rigid = md_rigid_error(sim, np)
    temps = snapshot_temperatures(sim, snaps, np)
    say(f"[{tag}] force parity {parity_s:.1f} s; run_dynamics_blocking("
        f"sim, 0.002, {N_BIO_STEPS}, {interval}): {ms_step:.4f} ms/step, "
        f"{ns_day:.3f} ns/day, T {t_final:.2f} K, {len(snaps)} snapshots "
        f"(T {', '.join(f'{v:.1f}' for v in temps)} K), solute extent "
        f"{extent:.2f} A, rigid waters |d(O-H) - r_OH| {rigid:.2e} A, "
        f"finite={finite}")
    if not finite or not 100.0 < t_final < 600.0 or len(snaps) != 4 \
            or not rigid < RIGID_TOL or not extent < BIO_EXTENT:
        raise SystemExit(f"phase {tag}: finite={finite} T={t_final} "
                         f"snapshots={len(snaps)} rigid={rigid} "
                         f"extent={extent}")
    return dict(method=sim.method, backend=sim._nbr_backend,
                solute_atoms=int(spec.n_atoms),
                sites=int(a.topology.n_atoms_real),
                padded=int(a.topology.n_atoms), waters=int(a.n_waters),
                box=box, build_s=build_s, fire_s=r["seconds"],
                fire_iters=r["iters"], parity_s=parity_s,
                ms_per_step=ms_step, ns_per_day=ns_day,
                temperature_K=t_final, snapshot_T=temps, extent_A=extent)


def protein_phase(torch, np):
    """Phase V: a protein from its sequence, at full width. HP35 through
    predict_structure(model="baseline"), write_mmcif / read_mmcif and
    prepare_peptide; the same chain again as the CPU's path gives the
    same MolSpec field for field; then solvated_run. Then BASELINE config
    2: the 12-mer prepared the same way, build_dynamics in vacuum at
    tests/test_peptide.py's MdConfig in float32 on the card, its force card
    vs CPU at phase 28's gate, N_CONFIG2_STEPS steps of 1 fs: finite, 100 K
    < T < CONFIG2_T_MAX, extent below BIO_EXTENT."""
    import tempfile

    from molchanica_tpu_torch.io.mmcif import read_mmcif, write_mmcif
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)
    from molchanica_tpu_torch.md.dynamics import MolDynamics, build_dynamics
    from molchanica_tpu_torch.molecules.peptide import prepare_peptide
    from molchanica_tpu_torch.molecules.spec_json import spec_to_dict
    from molchanica_tpu_torch.structure_prediction import predict_structure

    def chain(seq, path):
        write_mmcif(predict_structure(seq, model="baseline"), path)
        return prepare_peptide(read_mmcif(path))

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spec = chain(HP35_SEQ, os.path.join(tmp, "hp35.cif"))
        prep_s = time.perf_counter() - t0
        same = spec_to_dict(chain(HP35_SEQ, os.path.join(tmp, "b.cif"))) \
            == spec_to_dict(spec)
        spec12 = chain(CONFIG2_SEQ, os.path.join(tmp, "c2.cif"))
    q = float(np.sum(spec.charges))
    say(f"[V] HP35 {HP35_SEQ}: baseline fold, mmCIF round trip and "
        f"prepare_peptide in {prep_s:.2f} s: {spec.n_atoms} atoms, net "
        f"charge {q:+.6f}, {len(spec.bonds)} bonds, {len(spec.dihedrals)} "
        f"dihedrals; the CPU path's MolSpec equal field for field: {same}")
    if not same or abs(q - round(q)) > 1e-6:
        raise SystemExit(f"phase V: prepared spec same={same} charge={q}")
    out = dict(hp35=solvated_run("V", spec, "peptide", torch, np),
               hp35_atoms=int(spec.n_atoms), hp35_charge=q, prep_s=prep_s)

    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=5.0),
                   temp_target=300.0,
                   hydrogen_constraint=HydrogenConstraint.shake(),
                   dtype="float32", max_init_relaxation_iters=400, seed=3)

    def build(c, device):
        return build_dynamics([MolDynamics(ff_mol_type="peptide",
                                           spec=spec12)], c, device=device)

    t0 = time.perf_counter()
    sim = build(cfg, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    r = sim.relax_log
    say(f"[V] config 2: {CONFIG2_SEQ} prepared, {spec12.n_atoms} atoms, "
        f"net charge {float(np.sum(spec12.charges)):+.6f}, in vacuum: "
        f"build_dynamics {build_s:.2f} s, method {sim.method}; FIRE "
        f"{r['iters']} iterations in {r['seconds']:.2f} s ({r['path']}), E "
        f"{r['e_first']:.3f} -> {r['e_last']:.3f} kcal/mol")
    allpairs_parity(build(cfg.replace(max_init_relaxation_iters=None),
                          "cuda"),
                    build(cfg.replace(max_init_relaxation_iters=None),
                          "cpu"), "allpairs", "V", torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(0.001, N_CONFIG2_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    t_final = sim.temperature()
    x = sim.state.positions.cpu().numpy()
    finite = bool(np.isfinite(x).all()) and bool(
        torch.isfinite(sim.state.pe_last))
    extent = float(np.ptp(x[:spec12.n_atoms], axis=0).max())
    ms_step = elapsed / N_CONFIG2_STEPS * 1e3
    say(f"[V] config 2: {N_CONFIG2_STEPS} steps of 1 fs, {ms_step:.4f} "
        f"ms/step, T {t_final:.2f} K, extent {extent:.2f} A, "
        f"finite={finite}")
    if not finite or not 100.0 < t_final < CONFIG2_T_MAX \
            or not extent < BIO_EXTENT:
        raise SystemExit(f"phase V config 2: finite={finite} T={t_final} "
                         f"extent={extent}")
    out["config2"] = dict(atoms=int(spec12.n_atoms), build_s=build_s,
                          fire_s=r["seconds"], ms_per_step=ms_step,
                          temperature_K=t_final, extent_A=extent)
    return out


def duplex_phase(torch, np):
    """Phase W: config 5's DNA duplex, MoleculeNucleicAcid.from_seq(
    DUPLEX_SEQ, double=True).to_spec() (the net charge -1 per phosphate
    within DUPLEX_CHARGE_TOL), solvated through solvated_run."""
    from molchanica_tpu_torch.molecules.nucleic_acid import \
        MoleculeNucleicAcid

    t0 = time.perf_counter()
    na = MoleculeNucleicAcid.from_seq(DUPLEX_SEQ, double=True)
    spec = na.to_spec()
    build_s = time.perf_counter() - t0
    n_p = sum(1 for e in na.common.elements if e == "P")
    q = float(np.sum(spec.charges))
    say(f"[W] duplex {DUPLEX_SEQ}/{DUPLEX_SEQ[::-1]} built and "
        f"parameterized in {build_s:.2f} s: {spec.n_atoms} atoms, {n_p} "
        f"phosphates, net charge {q:+.9f}")
    if abs(q + n_p) > DUPLEX_CHARGE_TOL or n_p != 2 * (len(DUPLEX_SEQ) - 1):
        raise SystemExit(f"phase W: {n_p} phosphates, charge {q}")
    res = solvated_run("W", spec, "dna", torch, np)
    res.update(atoms=int(spec.n_atoms), charge=q, phosphates=n_p,
               host_build_s=build_s)
    return res


def membrane_editor_phase(torch, np):
    """Phase X: make_membrane() at its defaults, assembled dry in its box
    at tests/test_lipid.py's MdConfig in float32, MdSim on the card (FIRE
    at construction), its force card vs CPU at the initial state
    (relaxation off), N_MEMBRANE_STEPS steps of 1 fs at MEMBRANE_FORCE_CAP:
    finite, T below MEMBRANE_T_MAX, the leaflets' P atoms more than
    LEAFLET_GAP A apart in z. Then MolEditor(device=None) through
    tests/test_editor.py's sequence: ethane with its second carbon pulled
    out 1.6x along the C-C bond, N_EDITOR_TICKS md_step ticks (the bond
    shorter by more than EDITOR_RELAX A), an O added mid-run (the sim
    rebuilt lazily: 9 atoms, finite positions); its build and tick
    times."""
    from molchanica_tpu_torch import device as devices
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)
    from molchanica_tpu_torch.md.engine import MdSim
    from molchanica_tpu_torch.molecules.editor import MolEditor
    from molchanica_tpu_torch.molecules.lipid import make_membrane
    from molchanica_tpu_torch.molecules.spec import assemble_system

    t0 = time.perf_counter()
    mols, box = make_membrane()
    asys = assemble_system(mols, box_extent=box, seed=1)
    host_s = time.perf_counter() - t0
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=5.0),
                   temp_target=310.0, lj_cutoff=7.0, coulomb_cutoff=7.0,
                   hydrogen_constraint=HydrogenConstraint.shake(),
                   dtype="float32", max_init_relaxation_iters=200,
                   steps_per_chunk=50, seed=4)

    def build(c, device):
        return MdSim(asys.topology, c, asys.positions,
                     box_extent=asys.box_extent, device=device)

    t0 = time.perf_counter()
    sim = build(cfg, None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    r = sim.relax_log
    say(f"[X] make_membrane(): {len(mols)} PC lipids, "
        f"{asys.topology.n_atoms_real} atoms ({asys.topology.n_atoms} "
        f"padded), box {' x '.join(f'{v:.4f}' for v in box)} A, host "
        f"{host_s:.2f} s; MdSim on {sim.device} {build_s:.2f} s, method "
        f"{sim.method} ({sim._nbr_backend}); FIRE {r['iters']} iterations "
        f"in {r['seconds']:.2f} s ({r['path']}, kept {r['kept']}), E "
        f"{r['e_first']:.3f} -> {r['e_last']:.3f} kcal/mol")
    card = devices.resolve_device(None)
    if sim.device != card:
        raise SystemExit(f"phase X: MdSim on {sim.device}, not {card}")
    dense_or_cluster_parity(lambda dev: build(cfg.replace(
        max_init_relaxation_iters=None), dev), "X", torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(0.001, N_MEMBRANE_STEPS, force_cap=MEMBRANE_FORCE_CAP)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    t_final = sim.temperature()
    x = sim.state.positions.cpu().numpy()
    finite = bool(np.isfinite(x).all()) and bool(
        torch.isfinite(sim.state.pe_last))
    starts = list(asys.mol_start_indices) + [asys.n_solute_atoms]
    pz = np.array([x[s + int(np.argmax(np.abs(np.asarray(m.masses)
                                               - 30.97) < 0.1)), 2]
                   for s, m in zip(starts, mols)])
    half = len(mols) // 2
    gap = float(pz[:half].min() - pz[half:].max())
    ms_step = elapsed / N_MEMBRANE_STEPS * 1e3
    say(f"[X] {N_MEMBRANE_STEPS} steps of 1 fs at force_cap "
        f"{MEMBRANE_FORCE_CAP:g}: {ms_step:.4f} ms/step, T {t_final:.2f} K,"
        f" leaflet P gap {gap:.3f} A (upper min z {pz[:half].min():.3f}, "
        f"lower max z {pz[half:].max():.3f}), finite={finite}")
    if not finite or not t_final < MEMBRANE_T_MAX or not gap > LEAFLET_GAP:
        raise SystemExit(f"phase X membrane: finite={finite} T={t_final} "
                         f"gap={gap}")
    out = dict(membrane=dict(lipids=len(mols),
                             atoms=int(asys.topology.n_atoms_real),
                             box=[float(v) for v in box],
                             method=sim.method, build_s=build_s,
                             fire_s=r["seconds"], ms_per_step=ms_step,
                             temperature_K=t_final, leaflet_gap_A=gap))
    del sim

    ed = MolEditor(dt_ps=0.0005, steps_per_tick=5)
    c = ed.add_atom("C")
    c2 = ed.add_atom("C", bond_to=c)
    ed.add_hydrogens(c, count=3)
    ed.add_hydrogens(c2, count=3)
    pos = np.asarray(ed.mol.positions)
    pos[1] = pos[0] + (pos[1] - pos[0]) * 1.6
    ed.mol.positions = pos
    d0 = float(np.linalg.norm(pos[1] - pos[0]))
    ed.start()
    ticks = []
    for _ in range(N_EDITOR_TICKS):
        t0 = time.perf_counter()
        ed.md_step()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t0)
    dev = ed._sim.device
    p = np.asarray(ed.mol.positions)
    d1 = float(np.linalg.norm(p[1] - p[0]))
    ed.add_atom("O", bond_to=1)
    rebuilt = ed._sim is None
    t0 = time.perf_counter()
    ed.md_step()
    torch.cuda.synchronize()
    tick_o = time.perf_counter() - t0
    finite = bool(np.isfinite(np.asarray(ed.mol.positions)).all())
    say(f"[X] MolEditor on {dev}: C-C {d0:.4f} -> {d1:.4f} A over "
        f"{N_EDITOR_TICKS} ticks of 5 steps (first tick with the build and "
        f"FIRE {ticks[0] * 1e3:.1f} ms, then "
        f"{np.mean(ticks[1:]) * 1e3:.2f} ms per tick); O added: rebuilt "
        f"{rebuilt}, {ed.mol.n_atoms} atoms, tick with the rebuild "
        f"{tick_o * 1e3:.1f} ms, finite={finite}")
    if dev != card or not d1 < d0 - EDITOR_RELAX or not rebuilt \
            or ed.mol.n_atoms != 9 or not finite:
        raise SystemExit(f"phase X editor: {dev} {d0} -> {d1}, rebuilt "
                         f"{rebuilt}, {ed.mol.n_atoms} atoms, "
                         f"finite={finite}")
    out["editor"] = dict(d0=d0, d1=d1, first_tick_s=ticks[0],
                         tick_ms=float(np.mean(ticks[1:]) * 1e3),
                         rebuild_tick_s=tick_o)
    return out


def decode_png(path, np):
    """[H, W, 3] uint8 of an 8-bit RGB PNG with filter-0 rows, decoded
    here with zlib and struct (apart from the port's writer)."""
    import struct
    import zlib
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise SystemExit(f"{path}: not a PNG")
    pos, idat, w = 8, b"", None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise SystemExit(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (raw[:, 0] != 0).any():
        raise SystemExit(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def frame_snapshot(asys, x, t_ps, np):
    """(Snapshot, elements, bonds) of an assembled solvated system at
    base-order positions x: the solute with its bonds and elements (from
    the masses), the waters' O / H1 / H2 rows, the box."""
    from molchanica_tpu_torch.md.snapshot import Snapshot
    from molchanica_tpu_torch.molecules.elements import ELEMENT_MASSES

    top = asys.topology
    ws, wc, stride = top.water_start, top.water_count, top.water_site_count
    m = top.masses[:ws].numpy()
    names = list(ELEMENT_MASSES)
    ref = np.asarray([ELEMENT_MASSES[e] for e in names])
    els = [names[int(np.argmin(np.abs(ref - v)))] for v in m]
    b = top.bond_idx.numpy()
    b = b[(top.bond_k.numpy() > 0) & (b < ws).all(axis=1)]
    w = x[ws:ws + wc * stride].reshape(wc, stride, 3)
    snap = Snapshot(time=t_ps, atom_posits=x[:ws], water_o_posits=w[:, 0],
                    water_h0_posits=w[:, 1], water_h1_posits=w[:, 2],
                    box_extent=np.asarray(asys.box_extent, float))
    return snap, els, [tuple(map(int, r)) for r in b]


def jittered_vsites(top, np):
    """A copy of `top` with each vsite's weight scaled by 1 + VSITE_JITTER
    N(0, 1): FastSim's layout test then sends it down the general path."""
    import dataclasses

    import torch
    w = top.vsite_weight.numpy().astype(np.float64)
    rng = np.random.default_rng(VSITE_SEED)
    w = w * (1.0 + VSITE_JITTER * rng.normal(size=w.shape))
    return dataclasses.replace(
        top, vsite_weight=torch.as_tensor(w.astype(np.float32)))


def config3_cfg():
    """Config 3's MdConfig: Langevin-middle at 310 K, 9 A cutoffs, SHAKE,
    float32, a neighbor rebuild every 20 steps."""
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)
    return MdConfig(
        integrator=Integrator.langevin_middle(gamma=1.0), temp_target=310.0,
        lj_cutoff=9.0, coulomb_cutoff=9.0,
        hydrogen_constraint=HydrogenConstraint.shake(), dtype="float32",
        max_init_relaxation_iters=None, neighbor_rebuild_every=20, seed=7)


def reordered_vsite(top, np):
    """A copy of `top` whose first vsite row lists its parents as O, H2,
    H1: the same M sites and forces as `top`, but FastSim's layout test
    sends it down the general (gather) path."""
    import dataclasses
    idx = top.vsite_idx.clone()
    r = int(np.flatnonzero(top.vsite_mask.numpy() > 0)[0])
    idx[r, 2], idx[r, 3] = top.vsite_idx[r, 3], top.vsite_idx[r, 2]
    return dataclasses.replace(top, vsite_idx=idx)


def vsite_paths(top, cfg, x, box, n_steps, torch, np, tag, v=None):
    """The rolled vsite path (`top`, blocked OPC) against the gather path
    on the same physical system (`top` with one reordered row), on the
    card from the same positions and velocities (None: at rest): the
    temperature after the first `n_steps` steps, then two alternating
    rounds of `n_steps` timed steps each. Returns {path: (T, [ms/step of
    the two rounds])}."""
    from molchanica_tpu_torch.md.fast_engine import FastSim
    v = np.zeros_like(x) if v is None else v
    sims = {"rolled": FastSim(top, cfg, x, box_extent=box, velocities=v,
                              device="cuda"),
            "gather": FastSim(reordered_vsite(top, np), cfg, x,
                              box_extent=box, velocities=v, device="cuda")}
    if not sims["rolled"]._vsites_rolled or sims["gather"]._vsites_rolled:
        raise SystemExit(f"{tag}: the layouts took the wrong vsite paths")
    res = {}
    for name, sim in sims.items():
        sim.step(0.002, n_steps)
        res[name] = (sim.temperature(), [])
    for _ in range(2):
        for name, sim in sims.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.step(0.002, n_steps)
            torch.cuda.synchronize()
            res[name][1].append((time.perf_counter() - t0) / n_steps * 1e3)
    say(f"[{tag}] vsite paths on {top.n_atoms_real} sites from "
        f"{'rest' if not np.any(v) else 'the given velocities'}: " + "; ".join(
            f"{k} T {t:.2f} K after {n_steps} steps, then "
            f"{' / '.join(f'{m:.3f}' for m in ms)} ms/step"
            for k, (t, ms) in res.items()) + f" ({card_line()})")
    return res


def cli_phase(asys, x3, t3, asys_h, cfg_h, x_h, torch, np):
    """Phase Y: the CLI slice on the card. One subprocess runs the CLI as a
    user does (python3 -m molchanica_tpu_torch with fetch, characterize,
    energy, minimize 50, md N_CLI_MD, predict, png, session save: its
    default device, the card) while this process checks the embedded
    tables without pandas, FastSim's general vsites on the hydration
    system (phase 11's, M weights jittered: the force card vs CPU at
    phase 6's gate, N_VSITE_STEPS steps finite with T in 100-600 K, every
    M at its construction within VSITE_TOL, K1 launches 2 x the force
    evaluations) and a background `bg md` with `energy` while it runs.
    Then the subprocess's gates (rc 0; 24 atoms; every energy term within
    its printed precision of the CPU's and the card's terms within
    CLI_ENERGY_TOL of the CPU's; md's T finite in 100-600 K; the PNG 900 x
    700 with >= 1% ink; the session loaded on the CPU), and the 25k-site
    frame of config 3 (x3 at t3) rendered: primitives, fragments and
    render ms on the card after a warm-up, and >= RENDER_SHARE of its
    pixels within RENDER_TOL / 255 of the same code on the CPU."""
    import importlib.util
    import re
    import tempfile

    from molchanica_tpu_torch import cli, mol_db, render
    from molchanica_tpu_torch.md.fast_engine import FastSim
    from molchanica_tpu_torch.ops.colpair import ColpairDirect

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    png, sess = os.path.join(tmp, "glucose.png"), os.path.join(tmp, "s.json")
    cmds = ["fetch glucose", "characterize", "energy", "minimize 50",
            f"md {N_CLI_MD}", f"predict {CLI_TARGET} CCO", f"png {png}",
            f"session save {sess}"]
    t_sub = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "molchanica_tpu_torch",
                             *cmds], cwd=ROOT, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        # the embedded tables on this machine
        t0 = time.perf_counter()
        dbs = mol_db.load_embedded_dbs()
        rows = {k: (len(v), len(v.filter_druglike())) for k, v in dbs.items()}
        hit = mol_db.lookup_by_name("glucose", dbs)
        say(f"[Y] tables {rows} (pandas importable here: "
            f"{importlib.util.find_spec('pandas') is not None}); glucose "
            f"from {hit[0] if hit else None}: {hit[1].smiles if hit else ''}"
            f" in {time.perf_counter() - t0:.2f} s")
        if rows != DB_ROWS or hit is None or hit[0] != \
                "metabolites_hmdb_core" or hit[1]["name"] != "glucose":
            raise SystemExit(f"phase Y tables: {rows}, {hit}")
        out["tables"] = rows

        # FastSim's general virtual sites on the hydration system
        t0 = time.perf_counter()
        top_j = jittered_vsites(asys_h.topology, np)
        built = {}

        def build_j(device):
            # at rest, as phases 13 and 19 start this state: 20 FIRE moves
            # leave the fresh water fill hot enough that velocities drawn
            # at 310 K read 615 K after 40 steps on an H100
            built[device] = FastSim(top_j, cfg_h, x_h,
                                    box_extent=asys_h.box_extent,
                                    velocities=np.zeros_like(x_h),
                                    device=device)
            return built[device]

        engine_parity(build_j, torch, tag="Y vsites")
        sim = built["cuda"]
        if sim._vsites_rolled or not sim._has_vsites:
            raise SystemExit("phase Y: the jittered layout took the rolled "
                             "vsite path")
        ColpairDirect.launches.clear()
        evals0 = sim.force_evals
        t1 = time.perf_counter()
        sim.step(0.002, N_VSITE_STEPS)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t1) / N_VSITE_STEPS * 1e3
        n_eval = sim.force_evals - evals0
        launches = dict(ColpairDirect.launches)
        t_v = sim.temperature()
        x = sim.positions_unsorted().astype(np.float64)
        vmask = top_j.vsite_mask.numpy() > 0
        vi = top_j.vsite_idx.numpy()[vmask]
        w = top_j.vsite_weight.numpy()[vmask].astype(np.float64)[:, None]
        box = np.asarray(asys_h.box_extent, np.float64)
        mi = lambda d: d - box * np.round(d / box)
        rel = mi(x[vi[:, 0]] - x[vi[:, 1]]) - w * (
            mi(x[vi[:, 2]] - x[vi[:, 1]]) + mi(x[vi[:, 3]] - x[vi[:, 1]]))
        m_err = float(np.abs(rel).max())
        finite = bool(np.isfinite(x).all())
        say(f"[Y] general vsites: {int(vmask.sum())} M sites, weights "
            f"{w.min():.6f}-{w.max():.6f}; {N_VSITE_STEPS} steps "
            f"{ms_step:.2f} ms/step, T {t_v:.1f} K, finite {finite}, M "
            f"construction max err {m_err:.2e} A; colpair launches "
            f"{launches} for {n_eval} force evaluations; "
            f"{time.perf_counter() - t0:.1f} s")
        if not (finite and 100.0 < t_v < 600.0 and m_err <= VSITE_TOL
                and sum(launches.values()) == 2 * n_eval and n_eval > 0):
            raise SystemExit(f"phase Y vsites: finite={finite} T={t_v} "
                             f"M err {m_err} launches {launches} n={n_eval}")
        del sim, built
        # the same start on the unjittered system, down the rolled path
        # and (one reordered row, the same physics) the gather path
        paths = vsite_paths(asys_h.topology, cfg_h, x_h, asys_h.box_extent,
                            N_VSITE_STEPS, torch, np, "Y")
        t_r, t_g = paths["rolled"][0], paths["gather"][0]
        if not abs(t_g - t_r) <= VSITE_T_REL * t_r:
            raise SystemExit(f"phase Y vsites: the gather path's T {t_g} "
                             f"against the rolled path's {t_r}")
        out["vsites"] = dict(ms_step=ms_step, T=t_v, m_err=m_err,
                             launches=sum(launches.values()),
                             force_evals=n_eval, paths=paths)

        # background MD on the card while the foreground computes
        t0 = time.perf_counter()
        st = cli.CliState()
        cli.handle_cmd(st, "fetch glucose")
        x0 = np.asarray(st.active_mol().positions).copy()
        msg = cli.handle_cmd(st, f"bg md {N_BG_MD}")
        name = msg.split("'")[1]
        handle = st.task_registry().get(name)
        e_fg = cli.handle_cmd(st, "energy")
        overlapped = handle.running
        terms_card = cli.energy_terms(st)
        done = cli.handle_cmd(st, f"wait {name}")
        moved = float(np.abs(np.asarray(st.active_mol().positions)
                             - x0).max())
        say(f"[Y] bg md {N_BG_MD}: energy returned while the task was "
            f"{'still running' if overlapped else 'already done (no overlap)'}"
            f"; {done.splitlines()[0]} {done.splitlines()[-1]}; the merged "
            f"molecule moved {moved:.3f} A; {time.perf_counter() - t0:.1f} s")
        if "FAILED" in done or "T =" not in done or not moved > 0.0 \
                or "energy_potential" not in e_fg:
            raise SystemExit(f"phase Y bg: {done!r} moved {moved}")
        out["bg"] = dict(overlapped=overlapped, moved=moved)

        # the CLI as a user runs it
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            raise SystemExit(f"phase Y: the CLI did not finish: {stderr}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    sub_s = time.perf_counter() - t_sub
    say("[Y] python3 -m molchanica_tpu_torch " + " ".join(
        f'"{c}"' for c in cmds) + f": rc {proc.returncode} in {sub_s:.1f} s")
    for line in stdout.splitlines():
        say(f"[Y]   {line}")
    if proc.returncode != 0:
        raise SystemExit(f"phase Y: the CLI exited {proc.returncode}: "
                         f"{stderr[-2000:]}")
    cpu = cli.CliState(device="cpu")
    cli.handle_cmd(cpu, "fetch glucose")
    terms_cpu = cli.energy_terms(cpu)
    scale = max(abs(v) for v in terms_cpu.values())
    printed = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\s*(\w+): +(-?[\d.]+) kcal/mol$", stdout, re.M)}
    card_err = max(abs(terms_card[k] - terms_cpu[k]) for k in terms_cpu)
    print_err = max(abs(printed.get(k, np.inf) - terms_cpu[k])
                    for k in terms_cpu)
    t_md = re.search(r"T = (\S+) K", stdout)
    t_md = float(t_md.group(1)) if t_md else float("nan")
    img = decode_png(png, np)
    ink = float((np.abs(img.astype(np.int32) - 255).max(-1) > 0).mean())
    back = cli.CliState(device="cpu")
    cli.handle_cmd(back, f"session load {sess}")
    n_back = back.active_mol().n_atoms
    say(f"[Y] energy terms: card vs CPU max |d| {card_err:.3e} (limit "
        f"{CLI_ENERGY_TOL * scale:.3e}), printed vs CPU {print_err:.2e}; md "
        f"T {t_md:.1f} K; PNG {img.shape[1]} x {img.shape[0]}, ink "
        f"{ink:.4f}; session back on the CPU: {n_back} atoms")
    if not ("24 atoms" in stdout and card_err <= CLI_ENERGY_TOL * scale
            and print_err <= CLI_PRINT_TOL + CLI_ENERGY_TOL * scale
            and np.isfinite(t_md) and 100.0 < t_md < 600.0
            and img.shape == (700, 900, 3) and ink >= CLI_PNG_FG
            and n_back == 24 and f"{CLI_TARGET}(CCO) = " in stdout):
        raise SystemExit("phase Y: the CLI's gates failed")
    out["cli"] = dict(seconds=sub_s, card_err=card_err, print_err=print_err,
                      md_T=t_md, png_ink=ink)

    # a 25k-site frame of config 3
    snap, els, bonds = frame_snapshot(asys, x3, t3, np)
    sc = render.snapshot_scene(snap, els, bonds)
    title = render.snapshot_title(snap)
    t0 = time.perf_counter()
    p = sc.primitives()
    prim_s = time.perf_counter() - t0
    stats = {}
    render.rasterize(p, title=title, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_g = render.rasterize(p, title=title, device="cuda", stats=stats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    img_c = render.rasterize(p, title=title, device="cpu")
    cpu_s = time.perf_counter() - t0
    d = (img_g.cpu().int() - img_c.int()).abs().amax(-1)
    share = float((d <= RENDER_TOL).double().mean())
    say(f"[Y] frame at t = {t3:.2f} ps: {len(snap.atom_posits)} solute "
        f"atoms, {len(snap.water_o_posits)} waters, {len(p)} primitives "
        f"({prim_s * 1e3:.1f} ms on the host), {stats['fragments']} "
        f"fragments; rasterized in {ms:.2f} ms on the card "
        f"({card_line()}), {cpu_s:.2f} s on the CPU; pixels within "
        f"{RENDER_TOL}/255 of the CPU's: {share:.6f} (max {int(d.max())})")
    if share < RENDER_SHARE:
        raise SystemExit(f"phase Y render: {share} < {RENDER_SHARE}")
    out["render"] = dict(primitives=len(p), fragments=stats["fragments"],
                         ms=ms, cpu_s=cpu_s, share=share)
    return out


def run_worker(group, out_path, torch, np):
    """One of WORKER_GROUPS in this process (chip_smoke.py --worker GROUP
    --worker-out PATH), each phase with its gates as in the whole script;
    writes {"phase_seconds": ..., "results": ...} to out_path as JSON."""
    from molchanica_tpu_torch import cuda_build
    cuda_build.build()
    phase_s, res = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        r = fn()
        phase_s[key] = round(time.perf_counter() - t0, 2)
        return r

    if group == "VWX":
        res["protein"] = timed("V", lambda: protein_phase(torch, np))
        res["duplex"] = timed("W", lambda: duplex_phase(torch, np))
        res["membrane_editor"] = timed(
            "X", lambda: membrane_editor_phase(torch, np))
    elif group == "IJKLM":
        res["logp"] = timed("I", lambda: logp_phase(torch, np))
        res["properties"] = timed(
            "J", lambda: dryrun_properties_phase(torch, np))
        res["docking"] = timed("K", lambda: docking_phase(torch, np))
        res["docking"]["shots"] = timed("L", lambda: shoot_phase(torch, np))
        res["density"] = timed("M", lambda: density_phase(torch, np))
    elif group == "NOPQRSTU":
        res["quickstart"], sim_n, mol_n = timed(
            "N", lambda: quickstart_phase(N_QS_STEPS, torch, np))
        res["ligand_k2"], md_o = timed(
            "O", lambda: ligand_k2_phase(N_O_WARM, N_O_STEPS, torch, np))
        res["checkpoint_trajectory"] = timed(
            "P", lambda: checkpoint_trajectory_phase(md_o, sim_n, mol_n,
                                                     torch, np))
        hb_n = hbond_inputs(sim_n, mol_n, np)
        asys_n, cfg_n = sim_n.assembled, sim_n.cfg
        del md_o, sim_n
        res["screening"], hits, library, template, parsed = timed(
            "Q", lambda: screening_phase(torch, np))
        top_hit = align_hit(hits, template)
        res["alignment_tools"] = timed("R", lambda: alignment_tools_phase(
            library[top_hit.name], template, hb_n, asys_n, cfg_n, mol_n,
            torch, np))
        res["adme"] = timed("S", lambda: adme_phase(parsed, torch, np))
        res["training"] = timed("T", lambda: train_phase(parsed, torch, np))
        res["mpnn"] = timed("U", lambda: mpnn_phase(torch, np))
    else:
        raise SystemExit(f"chip_smoke --worker: no group {group!r}")
    say(f"[worker {group}] phase_seconds {json.dumps(phase_s)}")
    with open(out_path, "w") as fh:
        json.dump(dict(phase_seconds=phase_s, results=res), fh, default=str)


def start_workers():
    """Start one process per WORKER_GROUPS entry (this script with
    --worker), WORKER_THREADS CPU threads each, their output to log files
    in a new temporary directory; an exit handler kills whatever still
    runs when this process ends. Returns [(group, Popen, log, out)]."""
    import atexit
    import ctypes
    import signal
    import tempfile

    # a SIGTERM ends this process through its exit handlers, and a worker
    # gets SIGKILL when this process dies by any other way
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    libc = ctypes.CDLL(None, use_errno=True)

    def die_with_parent():
        libc.prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG

    tmp = tempfile.mkdtemp(prefix="chip_smoke_workers_")
    env = dict(os.environ, OMP_NUM_THREADS=str(WORKER_THREADS),
               OPENBLAS_NUM_THREADS=str(WORKER_THREADS),
               MKL_NUM_THREADS=str(WORKER_THREADS))
    workers = []
    for group in WORKER_GROUPS:
        log = os.path.join(tmp, f"{group}.log")
        out = os.path.join(tmp, f"{group}.json")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 group, "--worker-out", out], cwd=ROOT,
                stdin=subprocess.DEVNULL, stdout=fh,
                stderr=subprocess.STDOUT, env=env,
                preexec_fn=die_with_parent)
        workers.append((group, proc, log, out))

    def kill():
        for _, proc, _, _ in workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(kill)
    return workers


def relay_worker(group, rc, log):
    """Print a worker's log, each line after its group's name."""
    with open(log) as fh:
        for line in fh:
            say(f"{group} | {line.rstrip()}")
    say(f"[workers] {group}: exit {rc}")


def check_workers(workers):
    """Fail at once when a worker has exited non-zero."""
    for group, proc, log, _ in workers:
        rc = proc.poll()
        if rc not in (None, 0):
            relay_worker(group, rc, log)
            raise SystemExit(f"chip_smoke: worker {group} failed (exit {rc})")


def finish_workers(workers, deadline):
    """Wait for every worker until `deadline` (time.time()), print its log
    and merge its phase seconds and results. Fails when a worker fails or
    is still running at the deadline (it is killed)."""
    secs, res = {}, {}
    for group, proc, log, out in workers:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the deadline"
        relay_worker(group, rc, log)
        if rc != 0:
            raise SystemExit(f"chip_smoke: worker {group} failed ({rc})")
        with open(out) as fh:
            data = json.load(fh)
        secs.update(data["phase_seconds"])
        res.update(data["results"])
    return secs, res


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=N_TIMED,
                    help="timed steps (default %(default)s)")
    ap.add_argument("--warm", type=int, default=N_WARM,
                    help="warm-up steps (default %(default)s)")
    ap.add_argument("--hold", type=int, default=0, metavar="N",
                    help="after the timed run, hold N more steps and check "
                    "their mean temperature (off by default)")
    ap.add_argument("--md-steps", type=int, default=N_MD_TIMED,
                    help="timed MdSim steps (default %(default)s)")
    ap.add_argument("--md-warm", type=int, default=N_MD_WARM,
                    help="MdSim warm-up steps (default %(default)s)")
    ap.add_argument("--ti-equil", type=int, default=N_TI_EQUIL,
                    help="equilibration steps per lambda window "
                    "(default %(default)s)")
    ap.add_argument("--ti-prod", type=int, default=N_TI_PROD,
                    help="production steps per lambda window "
                    "(default %(default)s)")
    ap.add_argument("--range-steps", type=int, default=N_RANGE_STEPS,
                    help="timed FastSim(per_slice_k=0) steps "
                    "(default %(default)s)")
    ap.add_argument("--range-warm", type=int, default=N_RANGE_WARM,
                    help="its warm-up steps (default %(default)s)")
    ap.add_argument("--shard-calls", type=int, default=N_SHARD_CALLS,
                    help="sharded colpair calls per variant and rank "
                    "(default %(default)s)")
    ap.add_argument("--sym-steps", type=int, default=N_SYM_STEPS,
                    help="timed FastSim(triangular=False) run steps "
                    "(default %(default)s)")
    ap.add_argument("--sym-warm", type=int, default=N_SYM_WARM,
                    help="its warm-up steps (default %(default)s)")
    ap.add_argument("--npt-steps", type=int, default=N_NPT_STEPS,
                    help="NPT run steps (default %(default)s)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, trace N more FastSim steps "
                    "with torch.profiler")
    ap.add_argument("--md-profile", type=int, default=0, metavar="N",
                    help="after the checks, trace N more MdSim steps")
    ap.add_argument("--mdd-profile", type=int, default=0, metavar="N",
                    help="after phase 26, trace N more steps of the "
                    "default MdSim")
    ap.add_argument("--out", metavar="DIR",
                    help="write chip_smoke.json (and profile.txt) here")
    ap.add_argument("--worker", choices=WORKER_GROUPS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "molchanica_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (molchanica_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    import numpy as np
    if args.worker:
        run_worker(args.worker, args.worker_out, torch, np)
        return

    # wall seconds per phase, printed before the kernel line
    phase_s = {}
    t_mark = [time.perf_counter()]
    workers = []

    def mark(key):
        now = time.perf_counter()
        phase_s[key] = round(now - t_mark[0], 2)
        t_mark[0] = now
        check_workers(workers)

    # ---- 1. the card ----
    card = card_line()
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    mark("1")

    # ---- 2. build ----
    from molchanica_tpu_torch import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    say(f"[build] {', '.join(os.path.basename(p) for p in cuda_build.SOURCES)}"
        f" built in {time.perf_counter() - t0:.1f} s; nvcc wall s per "
        "process (sources started together, then the link): "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    cuda_build.build_seconds.items()))
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say(f"[build] {line.strip()}")
    mark("2")

    # ---- 3. the system ----
    from molchanica_tpu_torch.md.fast_engine import FastSim
    from molchanica_tpu_torch.ops.colpair import ColpairDirect
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    t0 = time.perf_counter()
    asys = build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
    d = np.load(FIXTURE)
    if d["x"].shape != asys.positions.shape or not np.allclose(
            d["box"], np.asarray(asys.box_extent)):
        raise SystemExit("eq25k.npz does not match the built system")
    cfg = config3_cfg()
    say(f"[system] built {asys.topology.n_atoms_real} sites in "
        f"{time.perf_counter() - t0:.1f} s")

    def build(device):
        return FastSim(asys.topology, cfg, d["x"],
                       box_extent=asys.box_extent, velocities=d["v"],
                       device=device)

    t0 = time.perf_counter()
    sim = build("cuda")
    torch.cuda.synchronize()
    sp = sim._split
    say(f"[system] FastSim init {time.perf_counter() - t0:.1f} s: S={sim.S} "
        f"S_L={sp['S_L']} S_Q={sp['S_Q']} cols={sim.plan.nx}x{sim.plan.ny} "
        f"pme={tuple(sim._recip.K)} box={float(asys.box_extent[0]):.4f} "
        f"tf32={torch.backends.cuda.matmul.allow_tf32}")
    mark("3")

    # ---- 4. kernel parity ----
    entries = kernel_parity(sim, torch)
    mark("4")

    # ---- 5. the main path ----
    ColpairDirect.launches.clear()
    evals0 = sim.force_evals
    dt = 0.002
    t0 = time.perf_counter()
    sim.step(dt, args.warm)
    torch.cuda.synchronize()
    say(f"[run] warm-up {args.warm} steps in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sim.step(dt, args.steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    e_pot = sim.potential_energy()
    torch.cuda.synchronize()
    counts = dict(ColpairDirect.launches)
    ms_step = elapsed / args.steps * 1e3
    ns_day = args.steps * dt / 1000.0 / elapsed * 86400.0
    t_final = sim.temperature()
    x = sim.positions_unsorted()
    finite = bool(np.isfinite(x).all())
    n_eval = sim.force_evals - evals0      # one per step, plus replans
    expected = 2 * n_eval
    total = sum(counts.values())
    say(f"[run] n={args.steps} ms/step={ms_step:.4f} ns/day={ns_day:.3f} "
        f"T={t_final:.2f} K E_pot={e_pot:.3f} kcal/mol finite={finite} "
        f"overflow={int(sim.state.overflow)} psk={sim._psk}")
    say(f"[run] colpair launches {total} (expected 2 x {n_eval} force "
        f"evaluations = {expected}): {counts}")
    for e in entries:
        e["launches"] = counts.get(e["name"], 0)
    if not finite or not 100.0 < t_final < 600.0:
        raise SystemExit(f"unstable run: finite={finite} T={t_final}")
    if not np.isfinite(e_pot):
        raise SystemExit("non-finite potential energy")
    if total != expected or any(e["launches"] == 0 for e in entries):
        raise SystemExit(f"kernel launches {counts} != {expected}")

    if args.hold:
        nvt_hold(sim, args.hold, np)
    mark("5")

    # ---- 6. engine parity ----
    engine_parity(build, torch)
    mark("6")

    # ---- 7. MdSim on the same system ----
    from molchanica_tpu_torch.md.engine import MdSim
    md_cfg = cfg.replace(use_pallas=True)

    def build_md(device):
        return MdSim(asys.topology, md_cfg, d["x"],
                     box_extent=asys.box_extent, velocities=d["v"],
                     method="cells_pme", relax=False, device=device)

    t0 = time.perf_counter()
    md = build_md("cuda")
    torch.cuda.synchronize()
    plan = md._plan
    sa = md._rebuild(md.state.positions, md.state.box)[0]
    occ = int((sa.view(plan.n_cells, plan.capacity) >= 0).sum(1).max())
    say(f"[md] MdSim init {time.perf_counter() - t0:.2f} s: nc={plan.nc} "
        f"C={plan.capacity} n_cells={plan.n_cells} max occupancy={occ} "
        f"side={plan.cell_side[0]:.4f} pme={md._recip.grid} "
        f"constraints={md.n_constraints}")
    mark("7")

    # ---- 8. K2 parity ----
    k2 = k2_parity(md, torch)
    mark("8")

    # ---- 9. the MdSim path ----
    md_res = md_path(md, [args.md_warm, args.md_steps], torch, np)
    k2["launches"] = md_res["launches"]
    entries.append(k2)
    mark("9")

    # ---- 10. MdSim engine parity ----
    md_engine_parity(build_md, torch)
    mark("10")

    # ---- 11. the hydration system ----
    asys_h, cfg_h, sim_h = hydration_system(torch, np)
    mark("11")

    # ---- 12. K1d parity ----
    alch_entries = kernel_parity(sim_h, torch, couples=ALCH_COUPLES)
    mark("12")

    # ---- 13. alchemical engine parity ----
    t0 = time.perf_counter()
    e_min = sim_h.minimize(cfg_h.neighbor_rebuild_every)
    torch.cuda.synchronize()
    say(f"[alch-engine] minimize({cfg_h.neighbor_rebuild_every}) on the "
        f"card: E_pot {e_min:.3f} kcal/mol before the last move, "
        f"{time.perf_counter() - t0:.1f} s")
    x_rel = sim_h.positions_unsorted()
    v_zero = np.zeros_like(x_rel)

    def build_h(device):
        return FastSim(asys_h.topology, cfg_h, x_rel,
                       box_extent=asys_h.box_extent, velocities=v_zero,
                       device=device)

    engine_parity(build_h, torch, lam=1.0 - ALCH_COUPLES[0],
                  tag="alch-engine")
    del sim_h
    mark("13")

    # ---- 14. the TI path ----
    ti, ti_counts = ti_path(args.ti_equil, args.ti_prod, torch, np)
    for e in alch_entries:
        e["launches"] = ti_counts.get(e["name"], 0)
    if any(e["launches"] == 0 for e in alch_entries):
        raise SystemExit(f"TI path: a K1d instance never launched: "
                         f"{ti_counts}")
    entries[4:4] = alch_entries
    mark("14")

    # ---- 15. K1c: FastSim on range tables ----
    range_entries, range_res = range_path(
        lambda: FastSim(asys.topology, cfg, d["x"],
                        box_extent=asys.box_extent, velocities=d["v"],
                        per_slice_k=0, device="cuda"),
        args.range_warm, args.range_steps, torch, np)
    entries[8:8] = range_entries
    mark("15")

    # ---- 16. K1f: the sharded colpair over ranks on the card ----
    shard_entries, shard_res = shard_phase(asys, d, args.shard_calls, torch,
                                           np)
    entries[12:12] = shard_entries
    mark("16")

    # ---- 17. the spatial dry run on the card ----
    from molchanica_tpu_torch.parallel.dryrun import dryrun_multidevice
    t0 = time.perf_counter()
    dry = dryrun_multidevice(4, "gloo", "cuda")
    say(f"[dryrun] {time.perf_counter() - t0:.1f} s, ranks on "
        f"{torch.cuda.get_device_name(0)}")
    mark("17")

    # ---- 18. K1e: FastSim on symmetric tables ----
    def build_sym(psk, per_slice_k=None):
        return FastSim(asys.topology, cfg, d["x"], box_extent=asys.box_extent,
                       velocities=d["v"], device="cuda", triangular=False,
                       per_slice_k=psk if per_slice_k is None else
                       per_slice_k)

    sym_entries, sym_res, sim_sym = sym_path(
        build_sym, lambda: build("cuda"), args.sym_warm, args.sym_steps,
        torch, np)
    sym_range_entries, sym_range_res = range_path(
        lambda: build_sym(None, per_slice_k=0), 0, N_SYM_RANGE_STEPS, torch,
        np, tag="sym-range")
    mark("18")

    # ---- 19. K1e has_alch on the hydration system ----
    sym_alch_entries = sym_alch_path(
        lambda: FastSim(asys_h.topology, cfg_h, x_rel,
                        box_extent=asys_h.box_extent, velocities=v_zero,
                        device="cuda", triangular=False),
        N_SYM_ALCH_STEPS, torch, np)
    mark("19")

    # ---- 20. K1g: the cross variant on config 3 ----
    cross_entries = cross_phase(sim_sym, N_CROSS_CALLS, torch, np)
    del sim_sym
    mark("20")

    # ---- 21. P: the probe ----
    probe_entry = probe_phase(torch, np)
    mark("21")

    # ---- 22. NPT on config 3 ----
    from molchanica_tpu_torch.md.config import BarostatCfg
    cfg_npt = cfg.replace(barostat_cfg=BarostatCfg(pressure_target=1.0,
                                                   tau=NPT_TAU))
    npt_res = npt_path(
        lambda: FastSim(asys.topology, cfg_npt, d["x"],
                        box_extent=asys.box_extent, velocities=d["v"],
                        device="cuda"),
        args.npt_steps, torch, np)
    entries += (sym_entries + sym_range_entries + sym_alch_entries
                + cross_entries + [probe_entry])
    mark("22")

    # ---- 23. K2 on a capacity-128 grid and an nc = 3 grid ----
    k2_grids = k2_grid_phase(torch, np)
    mark("23")

    # ---- 30. G: the screening farm on K2 (its kernel time before any
    # other process shares the card) ----
    farm_entry, farm_k2 = farm_k2_phase(asys, d, torch, np)
    entries.append(farm_entry)
    mark("G")

    # ---- the phases I-X in worker processes beside this one ----
    t_split = time.perf_counter()
    workers += start_workers()
    torch.set_num_threads(WORKER_THREADS)
    say(f"[workers] {', '.join(WORKER_GROUPS)} started "
        f"{time.time() - t_start:.1f} s after the start, "
        f"{WORKER_THREADS} CPU threads per process")

    # ---- 24. A: MdSim as a user gets it on config 3 ----
    md_d, mdd_init = default_md_phase(asys, d, torch, np)
    mark("A")

    # ---- 25. B: the cluster list and forces on A's state ----
    clus = cluster_phase(md_d, torch, np)
    mark("B")

    # ---- 26. C: A's path ----
    mdd = default_md_path(md_d, N_MDD_WARM, N_MDD_STEPS, torch, np)
    if args.mdd_profile:
        if args.out:
            os.makedirs(args.out, exist_ok=True)
        profile_steps(md_d, args.mdd_profile, torch, args.out, "mdd_")
    mark("C")

    # ---- 27. D: NPT on the cluster path ----
    mdd_npt = default_npt_path(md_d, N_MDD_NPT_STEPS, torch, np)
    del md_d
    mark("D")

    # ---- 28. E: vacuum ethanol, the verify recipe ----
    vac = vacuum_phase(N_VAC_STEPS, torch, np)
    mark("E")

    # ---- 29. F: alchemical MdSim on the hydration state ----
    alch_md = alch_md_phase(asys_h, cfg_h, x_rel, v_zero, N_MDD_ALCH_STEPS,
                            torch, np)
    mark("F")

    # ---- 31. H: run_sol_sim on the replica farm ----
    farm_h = hydration_farm_phase(asys_h, cfg_h, x_rel, torch, np)
    mark("H")

    # ---- 48. Y: the CLI, its tables, background work, the renderer, and
    # FastSim's general vsites ----
    cli_res = cli_phase(asys, sim.positions_unsorted(),
                        sim.step_count * dt, asys_h, cfg_h, x_rel, torch, np)
    mark("Y")

    # ---- the workers' phases ----
    secs, wres = finish_workers(workers, t_start + WORKER_DEADLINE)
    mark("wait")
    phase_s.update(secs)
    say(f"[workers] this process and the workers from the split: "
        f"{time.perf_counter() - t_split:.1f} s; the script so far "
        f"{time.time() - t_start:.1f} s")
    k2["launches_phase_o"] = wres["ligand_k2"]["launches"]

    # ---- 49. results ----
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.profile:
        profile_steps(sim, args.profile, torch, args.out)
    if args.md_profile:
        profile_steps(md, args.md_profile, torch, args.out, "md_")
    if args.out:
        with open(os.path.join(args.out, "build_log.txt"), "w") as fh:
            fh.write(cuda_build.build_log)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, ms_per_step=ms_step,
                           ns_per_day=ns_day, temperature_K=t_final,
                           elapsed_s=elapsed, n_timed=args.steps,
                           md=md_res, ti=ti, range=range_res,
                           shard=shard_res, dryrun=dry, sym=sym_res,
                           sym_range=sym_range_res, npt=npt_res,
                           k2_grids=k2_grids, mdd_init=mdd_init,
                           clusters=clus, mdd=mdd, mdd_npt=mdd_npt,
                           vacuum=vac, alch_md=alch_md, farm_k2=farm_k2,
                           farm_h=farm_h, cli=cli_res,
                           **wres, phase_seconds=phase_s, kernels=entries),
                      fh, indent=1, default=str)
    say("phase_seconds " + json.dumps(phase_s))
    say(json.dumps({"kernels": [
        {k: e[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for e in entries]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
