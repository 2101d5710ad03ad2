#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cfdnn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     from cfdnn_tpu_torch/csrc and report the build seconds;
  2. each kernel against its plain PyTorch twin on the card, float64 at
     32^3 (channel and LES channel 32x48x32, stretched; the duct 32x24x24;
     the LES + IBM channel 64x32x64) to 1e-12 * max|twin|, and float32 at
     the main-path shapes (128^3, the LES channel 128x64x128, the duct
     128x96x96, the LES + IBM channel 256x128x256) to 1e-5 * max|twin|:
     the channel predictor with and without a random nu_t >= 0, the
     general predictor with nu_t on the TGV grid and the duct, nu_sgs for
     each of its three closures on the channel and the duct (Smagorinsky
     on the LES + IBM channel), divergence and correct on the channel, the
     periodic box and the LES + IBM channel, germano_pass1's |S| and plane
     sums; in float64 also the general predictor on the other grids it
     serves (`_general_cases`); the
     transport kernel (`_transport_cases`) in float64 on four grids and in
     float32 at 128^3; the two predictor + divergence kernels
     (`_div_cases`): the periodic one at 32^3 and the channel one at
     32x48x32 (uniform and stretched y, skew and central, scalar nu and
     nu_t) in float64, at 128^3 and with nu_t at 128x64x128 in float32,
     each div output also against the divergence kernel of the kernel's
     own star (1e-12 / 1e-5 of scale); the two Hartley kernels
     (`_fht_cases`): float64 on every axis, forward, inverse and modal,
     for N1 = 1 ... 8 (N2 = 32) and N2 = 64, 96, 128, 160, 192, 224, 256
     (with the round trip = N x and the dense reference_forward), float32
     at 512^3 and 640^3 on every axis with the tgv512, channel512 and
     les_tgv640 solvers' symbols; the four
     xz kernels (`_xz_cases`) on the les_tgv640 plane 32x640x640 (the
     predictor with and without nu_t, nu_sgs, divergence, correct) and on
     small grids the xz gate serves (a stretched walled y, a lid, a
     periodic y, ragged tiles over two y chunks; skew and central;
     Smagorinsky, WALE and Vreman), float64
     to 1e-13 of scale and float32 to 1e-5, each against its twin and
     against the slab kernel of its function on the same inputs; the four
     slab kernels that walk an (x, z) tile (`_tile_cases`):
     predictor_channel, scalar nu and nu_t, skew and central, at nx = 8
     with ny = 2 and 3 and on the ragged 12x70x40 (several chunks);
     predictor_periodic at nx = 8 with ny = 1, 2, 3 (nz = 6), on the
     ragged 12x70x40 and at nx = 5 and 3; correct and divergence on the
     periodic box, the duct, a wall-x cavity, a 2-D grid and an nx = 5
     channel, divergence also on a ragged periodic 12x70x40 and a box of
     one y cell; the two closure kernels on walked tiles
     (`_closure_tile_cases`), nu_sgs for each closure and transport for
     each model, on stretched walled-y and periodic-y grids at nx = 8 with
     ny = 2 and 3 (nz = 6), the ragged 12x70x40, nx = 5 and 3, and the
     duct at 16x12x20, 8x3x6 and 12x20x70 (one to three z tiles),
     transport also on the channel with dp/dx = 0 and the periodic box;
     predictor_general and germano_pass1 on their walked tiles
     (`_general_tile_cases`): the predictor at nx = 8 with ny = 2 and 3
     (walled and periodic y), the ragged 12x70x40, ducts with nz = 31, 32
     and 33, a lid on y and on z and the xpad wrapper; germano_pass1 at
     nx = 3, 5 and 8, ny = 2 and 3, the ragged 12x70x40 and ducts of one
     to three z tiles, its plane sums also over a second launch, bit for
     bit (every germano_pass1 case); the two div kernels on their walked
     tiles (`_div_tile_cases`): predictor_periodic_div at nx = 1, 2, 3, 8
     and 9, nz = 6, 32, 33 and 35, ny = 1, 2 and 3 and on the ragged
     12x70x40 and 12x71x40, predictor_channel_div at nx = 8 and 9 with
     ny = 2 and 3, the same z and ragged shapes, stretched and uniform y,
     skew and central, scalar nu and nu_t, div also against the
     divergence kernel of the kernel's own star (the general and div
     cases between NaN bands); the O4 variants of predictor_general,
     divergence and correct (`_o4_cases`: space_order=4) in float64 at
     32^3 on the box, the stretched channel (skew and central, scalar nu
     and nu_t) and the duct, at nx = 8 with ny = 2, 3 and 4, on the
     ragged 12x70x40 and with periodic axes of 4 and 5 cells, and in
     float32 at the O4 paths' 128^3 and 128x64x128, each beside the O2
     kernel on the same inputs; fht_modal with tgv_re1600_o4's O4
     symbols at 128^3 and tgv_re1600_o4_512's at 512^3; the O4 variants
     of the xz kernels (`_xz_o4_cases`: predictor_general_xz skew and
     central, with and without nu_t, walled and periodic y;
     divergence_xz; correct_xz; nu_sgs_xz on an O4 grid) on the 512^3
     planes 32x512x512 of tgv_re1600_o4_512 and channel512_o4 and on
     small grids (nx = 8 and 12, ragged tiles over two y chunks, a
     stretched walled y, a lid, periodic y of 4 and 5 cells, between NaN
     bands), each against its twin and the O4 slab kernel of its
     function; predictor_general through the xpad wrapper on an INFLOW
     and an OUTFLOW x (`_xpad_cases`), with and without nu_t, skew and
     central, at the LES cylinder's 256x192x32 and at 9x5x32 (an odd x,
     nz = 32), between NaN bands; the upwind and upwind2 variants
     (`_upwind_cases`), each beside the skew kernel on the same inputs:
     the slab kernel (upwind2 on the O4 kernel's window) in float64 on
     the 32^3 box, the stretched channel 32x48x32, the duct, a lid, nx = 8
     with ny = 2, 3 and 4, the ragged 12x70x40, ducts with nz = 31, 32
     and 33 and moving z walls, the O4 variants at 32^3 and on edge
     grids, the xz kernels on small grids and on the 32x640x640 plane
     (also against the slab kernel), upwind through xpad on the LES
     cylinder's inflow and outflow x, and in float32 the 128^3 channel's
     call and the O4 channel's;
     float64 to 1e-14 of scale and float32 to 1e-5 (the xpad cases
     1e-12 and 1e-5); each output of a kernel is held to its own twin
     output's scale;
  3. capture (`phase_capture`): on each main path at its full width,
     `Simulation.run` (CUDA graphs) against the plain loop of the same step
     (`Simulation._run_loop`) from one state, 37 steps (two 16-step
     graphs, single steps, the last with diagnostics), every State member
     and diagnostic bit for bit, and 37 more from each result, again bit
     for bit, with the first captured State unchanged by the second run
     and the caller's state by either; the peak device memory of each;
     each graph's kernels (read off its nodes by name) its steps times
     the path's declared launches a step; on three paths the kernels
     torch.profiler records over a captured run equal to the loop's;
  4. the main paths (`_paths`), each with its launches per step declared:
     Simulation.run of the port's bench.py rows (the 128^3 Taylor-Green
     and channel, the 128x64x128 LES channel with static and dynamic
     Smagorinsky, the 128^3 LES Taylor-Green, the 128x96x96 LES duct, the
     128^3 RANS channel with SST, Wilcox k-omega and EARSM-WJ), the Re 1600
     Taylor-Green of examples/09 (RK3, adaptive dt, CFDNN_FUSE_DIV=1), the
     Taylor-Green, channel and LES channel with CFDNN_FUSE_DIV=1, the
     256x128x256 LES + IBM cylinder (with the opt-in set: a body takes no
     fused divergence), and the 512^3 Taylor-Green and channel with the
     Poisson transform "pallas_fft" (tgv512_pfht: four fht_pass and one
     fht_modal a step; channel512_pfht: two and one), and the 640^3 LES
     Taylor-Green (les_tgv640, 20 steps: the "xz" plan, each xz kernel
     once a step and no other kernel), and the three O4 paths
     (space_order=4: predictor_general, divergence and correct in their
     O4 variants): the Re 1600 Taylor-Green of validation/run_tgv1600.py
     --order 4 (tgv_re1600_o4, RK3, adaptive dt, three of each a step),
     the 128^3 channel (channel128_o4) and the 128x64x128 Smagorinsky
     channel (les_channel_o4, with nu_sgs); and O4 on the "xz" plan
     (the O4 variants of predictor_general_xz, divergence_xz and
     correct_xz): the Re 1600 Taylor-Green of validation/run_tgv1600.py
     --N 512 --order 4 (tgv_re1600_o4_512, three of each a step), run to
     t = 12 in runs of 20 steps, its dissipation peak -dKE/dt within
     [0.0120, 0.0136] at t within [8.4, 9.6] (the 512^3 spectral DNS:
     0.0127 near t = 9), and its peak device memory; and ROADMAP A.8:
     the 256x192x32 LES cylinder at Re 3900 of
     validation/run_les_cylinder3900.py (les_cylinder3900: the
     inflow/outflow pair with the convective outlet, WALE, RK3, adaptive
     dt, an immersed cylinder; predictor_general through xpad three times
     a step, no nu_sgs, divergence or correct), after its run u's inlet
     face the captured profile bit for bit, the outlet's flux anchor
     equal to the inlet flux to 1e-5 in each stage of a further step, and
     a second `initialize` with the inlet scaled by 1.5 pinned by the
     replayed graphs; and rans_channel_imex (rans_channel with implicit
     y-diffusion: the IMEX SST transport, no kernel), k, omega > 0; and
     ROADMAP A.2: channel_upwind and channel_upwind2, the 128^3 channel of
     scripts/measure_upwind.py:58-68 with the upwind schemes
     (predictor_general, divergence and correct once each a step);
     float32, 200 steps, use_pallas="auto", the launch
     counts set to 0 just before each run and read just after (the run
     replays graphs captured by a run before it; a replay adds the port's
     kernels its graph holds, counted by name off the graph's kernel nodes
     at capture, where they must equal the wrappers' launches of the
     capture), each
     kernel's count equal to 200 times its declared launches per step; the
     fields finite and of their shapes, the Taylor-Greens' kinetic energy
     decayed, the post-projection divergence (the fluid region's with
     IBM) <= 1e-3, the LES nu_t finite and >= 0; the adaptive dt within
     its CFL and diffusion bound and changing from step to step; the IBM
     forces finite and |u| inside the body < 0.05 max|u|. Before each
     unfused LES (and the IBM) run, the closure's nu_t on the initial
     state through the kernel plan finite, >= 0 and not 0 everywhere, and
     at float64 on the same grid equal to the plain twins' to
     1e-12 * max|twin|; after the static runs nu_t not 0 everywhere, after
     the dynamic one |S| > 0, <M:M> > 0 and <L:M> finite. Before each RANS
     run, the first step's (k, omega, nu_t) through the kernel plan equal
     to the plain math's at float64 to 1e-12 * max|plain|; after it k,
     omega > 0 and nu_t >= 0, finite and not 0 everywhere;
  5. each path at 32^3 (the LES and RANS channels and the fused channel
     32x24x32, the upwind channels 32x48x32, the duct 32x24x24, the
     LES + IBM channel 32x16x32; the
     "pallas_fft" paths 256x16x64 and 256x24x64, N1 = 2 on x) in float64
     for 20 steps, kernels on against use_pallas="off" on the card (the
     "pallas_fft" paths with cuFFT there) and against the eager operators
     on the CPU (the Hartley kernels' twins there; the CPU tests hold both
     to the JAX reference), <= 1e-11; and in forced "xz" (the port's
     SLAB_FIT_CELLS lowered while the Simulation is built) the LES
     Taylor-Green 32x32x64 and the stretched channel 32x24x64, 20 float64
     steps of the xz kernels on the card against the operators on the CPU,
     u, v, w, nu_t <= 1e-12 of each one's scale, p of the larger of its
     own and the velocity's; the same at O4 (the Taylor-Green, the
     channel and the central LES Taylor-Green: the O4 xz variants);
  5b. ROADMAP A.8 (`phase_a8`): the LES cylinder in float64 at
     64x48x16, 20 steps, kernels against use_pallas="off" on the card;
     rans_channel_imex in float64 at 32x24x32, 20 steps, the card against
     the CPU; each field to 1e-12 of its scale (p of the larger of its own
     and the velocity's); the 2-D Re 100 external cylinder of
     validation/run_cylinder_strouhal.py (384x256, 24000 steps of dt
     5e-3, float32), its Strouhal number within [0.15, 0.18], printed
     with the Cl amplitude and the seconds;
  6. the apps (`phase_apps`) through their entry points on the card:
     the 128^3 Re 1600 taylor_green_3d (float32, 300 steps, KE never
     rising, div_linf <= 1e-3), the channel's Poiseuille at 32x64x32
     (float64, rel L2 <= 4e-4), the 64x48x48 duct (float64, its steady
     series-solution error equal to the JAX package's CPU value to 1e-6)
     and a 32^3 float64 taylor_green_3d of 50 steps (KE and enstrophy to
     1e-10 of the JAX package's CPU values), each app's launches a step
     declared;
  7. timing: ms/step and Mcells/s of each unfused main-path step
     (marginal step time, as the port's bench.py; the 512^3 rows over 100
     steps) with a torch.profiler breakdown, beside the same of the plain
     loop of the step (on STEPWISE also a step a call, advance_unsteady
     with a callback against the loop stepped), the 512^3 rows also with the
     transform "auto" (cuFFT; tgv512, channel512) and each transform's
     div_linf after the first 100 steps; each kernel against its twin at
     the main-path shapes with CUDA events and with the profiler's device
     time, each div kernel also beside the unfused pair it stands for
     (its predictor kernel, then the divergence kernel of that star), the
     six slab kernels on a walked tile also at 512^3 (channel512's and
     tgv512's predictor and div kernel, tgv512's and channel512's correct
     and divergence, each held to its twin there too), the Hartley
     kernels beside torch.fft along the same axis
     (fht_pass beside one rfft or irfft, fht_modal beside rfft + irfft);
     the 512^3 Poisson solve alone, "fft" against "pallas_fft", on the
     tgv512 and channel512 solvers; les_tgv640 over 100 steps (one rep)
     with its profile, and each xz kernel at 640^3 beside its twin and
     the slab kernel of its function on the same inputs (with its float32
     difference from that slab kernel); tgv_re1600_o4_512 and the
     timed-only channel512_o4 (100 steps, one rep), and each O4 xz
     variant at 512^3 beside its twin and the O4 slab kernel of its
     function on the same inputs; predictor_general through xpad on the
     LES cylinder's inflow x beside its twin, with the pads alone; and
     the device ms/step of les_cylinder3900 and rans_channel_imex by
     part, each part timed alone (its plain chains captured in a CUDA
     graph and replayed under the profiler): the predictor, its pads,
     plain WALE, the FDM's GEMMs and cuFFT, IBM and the outlet's
     reductions; the Thomas sweeps; the momentum ladder of
     scripts/measure_upwind.py on the 128^3 channel (skew, central,
     upwind, upwind2: ms/step and device ms/step, with the card's name
     and power limit) and each upwind variant's float32 call beside its
     twin (the xz ones beside the slab kernel, the xpad one also its
     kernel alone, without the pads);
  8. the A/B: tgv, channel and les_channel unfused and fused, in the
     order off, on, on, off, ms/step and device ms/step of each.
It prints the `kernels` JSON line (each kernel's bound: the larger of its
main case's bytes over 3.35 TB/s and its operations over 67 TFLOP/s,
float32; library_ms, the Hartley kernels' torch.fft yardstick, null for
the stencils), the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Without a CUDA device it exits nonzero
before printing any result.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Tuple

import torch

F64_TOL = 1e-12
F32_TOL = 1e-5
TRAJ_TOL = 1e-11
MAIN_STEPS = 200
KERNEL_REPLACES = {
    "predictor_periodic": "cfdnn_tpu/ops/pallas_kernels.py:1373",
    "predictor_channel": "cfdnn_tpu/ops/pallas_kernels.py:1330",
    "predictor_general": "cfdnn_tpu/ops/pallas_kernels.py:318",
    "divergence": "cfdnn_tpu/ops/pallas_kernels.py:707",
    "correct": "cfdnn_tpu/ops/pallas_kernels.py:717",
    "nu_sgs": "cfdnn_tpu/ops/pallas_kernels.py:412",
    "germano_pass1": "cfdnn_tpu/ops/pallas_kernels.py:485",
    "transport": "cfdnn_tpu/ops/pallas_kernels.py:543",
    "predictor_periodic_div": "cfdnn_tpu/ops/pallas_kernels.py:1448",
    "predictor_channel_div": "cfdnn_tpu/ops/pallas_kernels.py:1524",
    "fht_pass": "cfdnn_tpu/poisson/pallas_fht.py:423",
    "fht_modal": "cfdnn_tpu/poisson/pallas_fht.py:450",
    "predictor_general_xz": "cfdnn_tpu/ops/pallas_kernels.py:834",
    "nu_sgs_xz": "cfdnn_tpu/ops/pallas_kernels.py:900",
    "divergence_xz": "cfdnn_tpu/ops/pallas_kernels.py:1051",
    "correct_xz": "cfdnn_tpu/ops/pallas_kernels.py:1060",
}
# the two Hartley kernels share csrc/fht.cuh, three xz kernels csrc/xz.cu,
# and the xz predictor, the channel, periodic and general predictors, the
# two div kernels, nu_sgs, germano_pass1 and transport (on their walked
# tiles) are headers with a source for each dtype
KERNEL_SOURCE = {"predictor_periodic": "predictor_periodic_tile.cuh",
                 "predictor_general": "predictor_general_tile.cuh",
                 "nu_sgs": "nu_sgs_tile.cuh",
                 "germano_pass1": "germano_tile.cuh",
                 "transport": "transport_tile.cuh",
                 "predictor_periodic_div": "predictor_periodic_div_tile.cuh",
                 "predictor_channel": "predictor_channel_tile.cuh",
                 "predictor_channel_div": "predictor_channel_div_tile.cuh",
                 "fht_pass": "fht.cuh", "fht_modal": "fht.cuh",
                 "predictor_general_xz": "predictor_general_xz.cuh",
                 "nu_sgs_xz": "xz.cu", "divergence_xz": "xz.cu",
                 "correct_xz": "xz.cu"}
# the O4 variant's source where it is not the kernel's own
KERNEL_SOURCE_O4 = {"predictor_general_xz": "predictor_general_xz_o4.cuh"}
# the xz kernels run their slab kernels' arithmetic on staged operands:
# float64 to 1e-13 of scale, against their twins and the slab kernels
XZ_F64_TOL = 1e-13
# the ten slab kernels that walk an (x, z) tile (predictor_channel,
# predictor_periodic, their div kernels, predictor_general, correct,
# divergence, nu_sgs, germano_pass1, transport) against their twins on the
# shapes where the tile can break
TILE_F64_TOL = 1e-14
# The H100 SXM's published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations a cell of each kernel (adds, multiplies, divisions and square
# roots, one each), counted by hand from its source (the head of each
# csrc/*.cu file), keyed by the case's label where its instantiations
# differ, else by the kernel's name; correct: three faces a cell; the
# periodic predictor's star u 52, v and w 51 each (154); the channel
# predictor's stars u, w, v, central 52 + 51 + 51 (154, skew 170), nu_t's
# viscosity averages and fluxes 46 more each (292); each div kernel, its
# predictor's and the divergence's 8 (162, with nu_t 300: the function's
# work; the slab kernels before them formed the three stars again at the
# +1 neighbours, 316 and 592);
# transport, the function's work a cell (tanh one, x^4 two multiplies,
# clamps none): the gradient, strain and centre velocity 69, the upwind
# advection of k and omega 34, k's production, source and both updates
# 17; SST's F1 blend 33 and its diffusivities nu_k, nu_om 12, each once a
# cell (a neighbour's are its own cell's), the diffusion 76, beta, alpha,
# the cross-diffusion and omega's source 19 (MODEL 0, "transport sst":
# 260), with nu_t of the clipped values 14 more (MODEL 1, the main case:
# 274); Wilcox's constant diffusivities 4 once a cell, its diffusion 76
# and omega's source 5 (MODEL 2: 205). The kernel forms F1 and the
# diffusivities 1.33 times a cell (its tile's x/z halo) where the slab
# kernel before it formed them seven times; the bound counts the
# function's work, whatever implements it. germano_pass1 likewise, the
# function's work with the separable filter: the centre velocity and its
# six products 12, the 3-point box sums of the nine quantities 54 (two
# adds an axis each), the filtered means, L, M and their weighted
# contractions 66 (nine divisions, L 12, M 9, L:M and M:M 36), the
# gradient 42 and the strain with |S| 20 (194; 600 counted the 27-point
# filter that the kernel before this one ran). The O4 variants, their
# function's work a cell: an O4 second difference times nu 10 a component
# and axis, an O4 first difference 5, an O4 mean 5 (f2c_mean4 or
# c2f_mean4), an O4 staggered difference 5 (divergence 17 on three O4
# axes, 14 on two; correct 7 a face on an O4 axis, 4 on an O2 one); the
# predictor on the box with skew (O2) convection 29 a component, O4
# diffusion 32 and the update 4 (196); on the channel with central
# convection (O4 along x and z, O2 across the walls: 151), diffusion 90
# (254), with nu_t's O2 diffusion 204 in its place (368).
OPS_PER_CELL = {"predictor_periodic": 154, "predictor_channel": 154,
                "predictor_channel+nu_t": 292,
                "predictor_channel les_ibm+nu_t": 292,
                "predictor_periodic_div": 162, "predictor_channel_div": 162,
                "predictor_channel_div+nu_t": 300,
                "predictor_general": 300, "divergence": 6, "correct": 9,
                "nu_sgs": 100, "germano_pass1": 194, "transport": 274,
                "transport sst": 260, "transport komega": 205,
                # the xz kernels: their slab kernels' functions
                "predictor_general_xz": 300, "nu_sgs_xz": 100,
                "divergence_xz": 6, "correct_xz": 9,
                # the O4 variants (`_o4_cases`' float32 labels)
                "predictor_general o4 tgv_re1600_o4 skew": 196,
                "predictor_general o4 channel128_o4 central": 254,
                "predictor_general o4 les_channel_o4 central+nu_t": 368,
                "divergence o4 tgv_re1600_o4": 17,
                "divergence o4 channel128_o4": 14,
                "divergence o4 les_channel_o4": 14,
                "correct o4 tgv_re1600_o4": 21,
                "correct o4 channel128_o4": 18,
                "correct o4 les_channel_o4": 18,
                # the O4 xz variants (`_xz_o4_cases`' 512^3 labels): their
                # slab kernels' counts, and the box's central convection O4
                # along all three axes (an own term 6, a cross term 31:
                # 210) with nu_t's O2 diffusion (427)
                "predictor_general_xz o4 tgv_re1600_o4_512 skew": 196,
                "predictor_general_xz o4 tgv_re1600_o4_512 central+nu_t":
                    427,
                "predictor_general_xz o4 channel512_o4 central": 254,
                "divergence_xz o4 tgv_re1600_o4_512": 17,
                "divergence_xz o4 channel512_o4": 14,
                "correct_xz o4 tgv_re1600_o4_512": 21,
                "correct_xz o4 channel512_o4": 18,
                # the upwind variants (`_upwind_cases`' float32 labels):
                # upwind a component 53 (u; v and w 52: an own term 3, a
                # cross term 9 with central's advecting velocity 6, the
                # scalar-nu diffusion 26, the update), 157; upwind2's
                # selected MUSCL difference 7 more a term (three
                # differences, two minmod products, the half difference
                # and the division), 9 terms, 220; the skew and central
                # kernels' own (the channel predictor's counts); at O4 the
                # central channel's 254 with each O4 first difference (5)
                # an upwind one (2), 6 terms, 236, and upwind2 299; with
                # nu_t 138 more (the channel's nu_t count)
                "predictor_general upwind channel 128^3": 157,
                "predictor_general upwind2 channel 128^3": 220,
                "predictor_general skew channel 128^3": 170,
                "predictor_general central channel 128^3": 154,
                "predictor_general o4 upwind channel128_o4": 236,
                "predictor_general o4 upwind2 channel128_o4": 299,
                "predictor_general_xz upwind les_tgv640 plane+nu_t": 295,
                "predictor_general_xz upwind2 les_tgv640 plane+nu_t": 358,
                "predictor_general xpad inflow les_cylinder3900 upwind+nu_t":
                    295,
                # the O4 box (three O4 axes, scalar nu): central's 210 with
                # each O4 first difference an upwind one, 27 fewer, the O4
                # diffusion and the update 108; upwind2 63 more
                "predictor_general_xz o4 upwind tgv_re1600_o4_512 plane": 291,
                "predictor_general_xz o4 upwind2 tgv_re1600_o4_512 plane":
                    354,
                "predictor_general_xz o4 skew tgv_re1600_o4_512 plane": 196}


class Case(NamedTuple):
    """One kernel call held against its twin: `inputs` are the tensors it
    reads (for the bytes of its bound); a div kernel's case carries its
    `geom`, for the divergence kernel of its own star; a Hartley case its
    operations per cell (`ops`, they depend on N) and its yardstick
    (`library`, torch.fft calls on the same tensor, named by the
    function's name: rfft, irfft or rfft_irfft); an xz case the slab
    kernel of the same function on the same inputs (`slab`); a div
    kernel's case the unfused predictor and divergence kernels it stands
    for, on the same inputs and that predictor's star (`pair`); a case
    with its own float64 limit carries it (`f64_tol`, of scale); a
    `banded` case's kernel is run with its outputs between NaN bands
    (`_banded_call`)."""
    label: str
    name: str
    kern: Callable
    twin: Callable
    inputs: Tuple[torch.Tensor, ...]
    geom: object = None
    ops: float = None
    library: Callable = None
    slab: Callable = None
    f64_tol: float = None
    banded: bool = False
    pair: Callable = None


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _banded(shape, dtype, device, bands):
    """An empty tensor of `shape` in the middle of a NaN-filled buffer
    three times its size, recorded in `bands`: a kernel that reads past it
    reads NaN, one that writes past it leaves a number in a band."""
    n = math.prod(shape)
    buf = torch.full((3 * n,), float("nan"), dtype=dtype, device=device)
    bands.append((buf, n))
    return buf[n:2 * n].view(shape)


def _band(t):
    """A copy of `t` between two NaN bands."""
    return _banded(tuple(t.shape), t.dtype, t.device, []).copy_(t)


class _BandedTorch:
    """torch as ops.kernels sees it during `_banded_call`: what it
    allocates (the kernels' outputs and partial sums, the xpad wrapper's
    padded fields) lies between NaN bands."""

    def __init__(self):
        self.bands = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, shape, *, dtype, device):
        return _banded(tuple(shape), dtype, device, self.bands)

    def empty_like(self, a):
        return _banded(tuple(a.shape), a.dtype, a.device, self.bands)

    def cat(self, ts):
        ref = torch.cat(ts)
        return _banded(tuple(ref.shape), ref.dtype, ref.device,
                       self.bands).copy_(ref)


def _banded_call(case):
    """case.kern() with every tensor the wrapper allocates between NaN
    bands as long as itself, in place of a memory checker (the card's
    machine runs none): fails if the kernel wrote into a band. With the
    case's inputs banded too (`_band`), a read past an input that reaches
    an output makes it NaN, which the comparison with the twin fails."""
    from cfdnn_tpu_torch.ops import kernels as K
    prev, K.torch = K.torch, _BandedTorch()
    try:
        got = case.kern()
        torch.cuda.synchronize()
    finally:
        banded, K.torch = K.torch, prev
    for buf, n in banded.bands:
        check(bool(buf[:n].isnan().all() and buf[2 * n:].isnan().all()),
              f"{case.label}: a kernel wrote past an output of "
              f"{n} elements")
    return got


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_build():
    from cfdnn_tpu_torch.ops import kernels
    path, seconds = kernels.build_library()
    kernels.library()
    print(f"[build] {path} in {seconds:.1f} s")
    # ptxas -v: each entry function (mangled, from the kernel's name and
    # template arguments on), then its registers
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Compiling entry" in line:
            print(f"[build] entry {line.split('_cu_')[-1][:72]}")
        elif "registers" in line:
            print(f"[build] {line.strip()[:120]}")


def _cases(n, dtype, device, seed):
    """A Case for each of the seven kernels on random fields at the main
    path's shapes: n^3, the channel stretched with Ny = n, the LES channel
    n x n/2 x n (both with Ny = 3n/2 for the float64 check), the LES duct
    n x 3n/4 x 3n/4, and the LES + IBM channel 2n x n x 2n (its
    predictor_channel with nu_t, nu_sgs, divergence and correct), and
    predictor_periodic on a periodic box of that shape too. The first
    case of each label is the main path's."""
    from cfdnn_tpu_torch import bench
    from cfdnn_tpu_torch.fields import velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    from cfdnn_tpu_torch.turbulence import les as L
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def geom(cfg):
        return Geometry.make(Mesh.from_config(cfg), cfg, device=device)

    def dt_of(cfg):
        return torch.full((), cfg.dt, dtype=dtype, device=device)

    dts = "float64" if dtype == torch.float64 else "float32"
    tgv = bench.les_tgv_config(n, dts).finalize()
    ch = bench.channel_config(n, dts).with_(
        Ny=n if dtype == torch.float32 else 3 * n // 2).finalize()
    les = bench.les_channel_config(n, dts).with_(
        Ny=n // 2 if dtype == torch.float32 else 3 * n // 2).finalize()
    duct = bench.les_duct_config(n, dts).finalize()
    ibm = bench.les_ibm_config(2 * n, dts).finalize()
    g_t, g_c, g_l, g_d = geom(tgv), geom(ch), geom(les), geom(duct)
    g_i = geom(ibm)
    ut, vt, wt = (rnd(s) for s in velocity_shapes(tgv))
    uc, vc, wc = (rnd(s) for s in velocity_shapes(ch))
    ul, vl, wl = (rnd(s) for s in velocity_shapes(les))
    ud, vd, wd = (rnd(s) for s in velocity_shapes(duct))
    ui, vi, wi = (rnd(s) for s in velocity_shapes(ibm))
    ub, vb, wb = (rnd((2 * n, n, 2 * n)) for _ in range(3))

    # an eddy viscosity >= 0 of the size Smagorinsky gives these fields
    def nut_of(cfg):
        return rnd((cfg.Nx, cfg.Ny, cfg.Nz)).abs() * 1e-3

    nut, nut_t, nut_d = nut_of(les), nut_of(tgv), nut_of(duct)
    nut_i, p_i = nut_of(ibm), rnd((ibm.Nx, ibm.Ny, ibm.Nz))
    pc, pt = rnd((ch.Nx, ch.Ny, ch.Nz)), rnd((tgv.Nx, tgv.Ny, tgv.Nz))
    dt_t, dt_c, dt_d, dt_i = dt_of(tgv), dt_of(ch), dt_of(duct), dt_of(ibm)
    ys = K.channel_y_arrays(g_c)
    kp = dict(hx=g_t.x.h, hy=g_t.y.h, hz=g_t.z.h, nu=tgv.nu, fx=0.0)
    kb = dict(kp, hx=g_t.x.h / 2, hz=g_t.z.h / 2)
    kc = dict(hx=g_c.x.h, hz=g_c.z.h, nu=ch.nu, fx=-ch.dp_dx,
              scheme=ch.convective_scheme)
    yl, gs = K.channel_y_arrays(g_l), K.les_arrays(g_l)
    kl = dict(hx=g_l.x.h, hz=g_l.z.h, nu=les.nu, fx=-les.dp_dx,
              scheme=les.convective_scheme)
    yi, gs_i = K.channel_y_arrays(g_i), K.les_arrays(g_i)
    ki = dict(hx=g_i.x.h, hz=g_i.z.h, nu=ibm.nu, fx=-ibm.dp_dx,
              scheme=ibm.convective_scheme)
    gen_t, gen_d = K.general_arrays(g_t), K.general_arrays(g_d)
    kg_t = dict(geom=g_t, nu=tgv.nu, fx=0.0, scheme=tgv.convective_scheme)
    kg_d = dict(geom=g_d, nu=duct.nu, fx=-duct.dp_dx,
                scheme=duct.convective_scheme)
    cases = [
        Case("predictor_periodic", "predictor_periodic",
             lambda: K.predictor_periodic(ut, vt, wt, dt_t, **kp),
             lambda: K.predictor_periodic_twin(ut, vt, wt, dt_t, **kp),
             (ut, vt, wt, dt_t)),
        # the periodic box at the LES + IBM channel's 2n x n x 2n, the
        # periodic predictor's time between 128^3 and 512^3
        Case("predictor_periodic 2n x n x 2n", "predictor_periodic",
             lambda: K.predictor_periodic(ub, vb, wb, dt_t, **kb),
             lambda: K.predictor_periodic_twin(ub, vb, wb, dt_t, **kb),
             (ub, vb, wb, dt_t)),
        Case("predictor_channel", "predictor_channel",
             lambda: K.predictor_channel(uc, vc, wc, dt_c, ys, **kc),
             lambda: K.predictor_channel_twin(uc, vc, wc, dt_c, *ys, **kc),
             (uc, vc, wc, dt_c, *ys)),
        Case("divergence", "divergence",
             lambda: K.divergence(uc, vc, wc, geom=g_c),
             lambda: K.divergence_twin(uc, vc, wc, geom=g_c),
             (uc, vc, wc, g_c.x.inv_d, g_c.y.inv_d, g_c.z.inv_d)),
        Case("correct", "correct",
             lambda: K.correct(uc, vc, wc, pc, dt_c, geom=g_c),
             lambda: K.correct_twin(uc, vc, wc, pc, dt_c, geom=g_c),
             (uc, vc, wc, pc, dt_c, g_c.x.inv_dc, g_c.y.inv_dc,
              g_c.z.inv_dc)),
        # the all-periodic grid of the TGV paths (no bounded axis)
        Case("divergence", "divergence",
             lambda: K.divergence(ut, vt, wt, geom=g_t),
             lambda: K.divergence_twin(ut, vt, wt, geom=g_t), (ut, vt, wt)),
        Case("correct", "correct",
             lambda: K.correct(ut, vt, wt, pt, dt_t, geom=g_t),
             lambda: K.correct_twin(ut, vt, wt, pt, dt_t, geom=g_t),
             (ut, vt, wt, pt, dt_t)),
        # the LES channel path
        Case("predictor_channel+nu_t", "predictor_channel",
             lambda: K.predictor_channel(ul, vl, wl, dt_c, yl, nu_t=nut, **kl),
             lambda: K.predictor_channel_twin(ul, vl, wl, dt_c, *yl, nut,
                                              **kl),
             (ul, vl, wl, dt_c, *yl, nut)),
        Case("germano_pass1", "germano_pass1",
             lambda: K.germano_pass1(ul, vl, wl, gs, geom=g_l),
             lambda: K.germano_pass1_twin(ul, vl, wl, geom=g_l),
             (ul, vl, wl, *gs)),
        # the LES Taylor-Green path, then the LES duct (central, walled z)
        Case("predictor_general+nu_t", "predictor_general",
             lambda: K.predictor_general(ut, vt, wt, dt_t, gen_t, nu_t=nut_t,
                                         **kg_t),
             lambda: K.predictor_general_twin(ut, vt, wt, dt_t, nut_t,
                                              **kg_t),
             (ut, vt, wt, dt_t, nut_t, *gen_t)),
        Case("predictor_general duct+nu_t", "predictor_general",
             lambda: K.predictor_general(ud, vd, wd, dt_d, gen_d, nu_t=nut_d,
                                         **kg_d),
             lambda: K.predictor_general_twin(ud, vd, wd, dt_d, nut_d,
                                              **kg_d),
             (ud, vd, wd, dt_d, nut_d, *gen_d)),
        # the LES + IBM channel path (its IBM forcing is plain torch)
        Case("predictor_channel les_ibm+nu_t", "predictor_channel",
             lambda: K.predictor_channel(ui, vi, wi, dt_i, yi, nu_t=nut_i,
                                         **ki),
             lambda: K.predictor_channel_twin(ui, vi, wi, dt_i, *yi, nut_i,
                                              **ki),
             (ui, vi, wi, dt_i, *yi, nut_i)),
        Case("nu_sgs les_ibm smagorinsky", "nu_sgs",
             lambda: K.nu_sgs(ui, vi, wi, gs_i, geom=g_i,
                              closure=L.SmagorinskyModel.closure,
                              coeff=L.SmagorinskyModel.coeff),
             lambda: K.nu_sgs_twin(ui, vi, wi, geom=g_i,
                                   closure=L.SmagorinskyModel.closure,
                                   coeff=L.SmagorinskyModel.coeff),
             (ui, vi, wi, *gs_i)),
        Case("divergence les_ibm", "divergence",
             lambda: K.divergence(ui, vi, wi, geom=g_i),
             lambda: K.divergence_twin(ui, vi, wi, geom=g_i),
             (ui, vi, wi, g_i.x.inv_d, g_i.y.inv_d, g_i.z.inv_d)),
        Case("correct les_ibm", "correct",
             lambda: K.correct(ui, vi, wi, p_i, dt_i, geom=g_i),
             lambda: K.correct_twin(ui, vi, wi, p_i, dt_i, geom=g_i),
             (ui, vi, wi, p_i, dt_i, g_i.x.inv_dc, g_i.y.inv_dc,
              g_i.z.inv_dc)),
    ]
    gs_d = K.les_arrays(g_d)
    for grid, g, fields, arrays in (("", g_l, (ul, vl, wl), gs),
                                    (" duct", g_d, (ud, vd, wd), gs_d)):
        for model in (L.SmagorinskyModel, L.WALEModel, L.VremanModel):
            kw = dict(geom=g, closure=model.closure, coeff=model.coeff)
            cases.append(Case(
                f"nu_sgs{grid} {model.closure}", "nu_sgs",
                lambda kw=kw, f=fields, a=arrays: K.nu_sgs(*f, a, **kw),
                lambda kw=kw, f=fields: K.nu_sgs_twin(*f, **kw),
                (*fields, *arrays)))
    return cases + _transport_cases(n, dtype, device, seed)


def _transport_cases(n, dtype, device, seed):
    """A Case for each instantiation of the transport kernel on random
    fields (u, v, w normal; k > 0, omega > 0, nu_t >= 0) with the model's
    own constants: float32 on the RANS channel n^3, whose first case (SST
    with nu_t) is the main path's; float64 on the stretched channel
    n x 3n/2 x n (the y+ pin active), the same channel with dp/dx = 0 (the
    pin on the wall cells only), the stretched duct n x 3n/4 x 3n/4 and
    the periodic box n^3."""
    from cfdnn_tpu_torch import TurbulenceModel, bench, velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    from cfdnn_tpu_torch.turbulence import transport as tr
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    dts = "float64" if dtype == torch.float64 else "float32"
    sst = dict(turb_model=TurbulenceModel.SST)
    every = ("sst_nut", "sst", "komega")
    channel = bench.rans_channel_config(n, dts)
    if dtype == torch.float32:
        grids = (("", channel, every),)
    else:
        channel = channel.with_(Ny=3 * n // 2)
        grids = (("", channel, every),
                 (" walls-pin", channel.with_(dp_dx=0.0), ("sst_nut",)),
                 (" duct", bench.les_duct_config(n, dts, **sst),
                  ("sst_nut",)),
                 (" box", bench.tgv_config(n, dts, **sst), every))
    cases = []
    for grid, cfg, models in grids:
        cfg = cfg.finalize()
        mesh = Mesh.from_config(cfg)
        g = Geometry.make(mesh, cfg, device=device)
        gs = K.transport_arrays(g)
        cell = (cfg.Nx, cfg.Ny, cfg.Nz)
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        k = rnd(cell).abs() * 1e-2 + 1e-4
        om = rnd(cell).abs() * 10.0 + 1.0
        nu_t = rnd(cell).abs() * 1e-3
        dt = torch.full((), cfg.dt, dtype=dtype, device=device)
        for model in models:
            turb = (tr.KOmegaTransport if model == "komega"
                    else tr.SSTTransport)(cfg, mesh, g)
            consts = turb.kernel_consts
            kw = dict(geom=g, model=model, c=turb.c, nu=cfg.nu,
                      om_wall=turb.om_wall)
            fields = (u, v, w, k, om, nu_t, dt)
            label = "transport" + grid + ("" if model == "sst_nut"
                                          else f" {model}")
            cases.append(Case(
                label, "transport",
                lambda f=fields, c=consts, a=gs, kw=kw: K.transport(
                    *f, c, a, **kw),
                lambda f=fields, c=consts, kw=kw: K.transport_twin(
                    *f, *c, **kw),
                (*fields, *consts, *gs)))
    return cases


def _general_cases(device, seed):
    """predictor_general on the other grids it serves, float64 at small
    shapes: the stretched wall-y channel (central, nu_t), the stretched
    duct (skew, nu_t), a moving lid (lid_velocity 1.3, skew, scalar nu), a
    periodic y with a stretched walled z (skew, nu_t), and the xpad
    wrapper on a no-slip x (skew, nu_t)."""
    from cfdnn_tpu_torch import BCType, Config
    from cfdnn_tpu_torch import ConvectiveScheme as CS
    from cfdnn_tpu_torch.fields import velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.float64

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    base = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype="float64")
    walls = dict(y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0)
    grids = (
        ("channel central+nu_t", dict(Nx=16, Ny=24, Nz=8, z_max=1.0,
                                      stretch_y=True,
                                      convective_scheme=CS.CENTRAL), True),
        ("duct skew+nu_t", dict(walls, Nx=16, Ny=12, Nz=10, x_max=4.0,
                                bc_z=BCType.WALL, stretch_y=True,
                                stretch_z=True, convective_scheme=CS.SKEW),
         True),
        ("lid skew", dict(Nx=16, Ny=12, Nz=8, y_min=0.0, y_max=1.0,
                          x_max=2.0, z_max=1.0, lid_velocity=1.3,
                          convective_scheme=CS.SKEW), False),
        ("periodic-y walled-z+nu_t", dict(walls, Nx=16, Ny=10, Nz=12,
                                          bc_y=BCType.PERIODIC, y_min=0.0,
                                          y_max=1.0, bc_z=BCType.WALL,
                                          stretch_z=True,
                                          convective_scheme=CS.SKEW), True),
        ("xpad wall-x+nu_t", dict(Nx=12, Ny=12, Nz=12, bc_x=BCType.WALL,
                                  bc_y=BCType.PERIODIC, y_min=0.0, y_max=1.0,
                                  x_max=1.5, z_max=2.0,
                                  convective_scheme=CS.SKEW), True),
    )
    cases = []
    for label, kw, with_nut in grids:
        cfg = Config(**base, **kw).finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        u, v, w = (rnd(s) for s in velocity_shapes(cfg))
        nu_t = (_band(rnd((cfg.Nx, cfg.Ny, cfg.Nz)).abs() * 1e-2)
                if with_nut else None)
        dt = _band(torch.full((), 1e-2, dtype=dtype, device=device))
        kg = dict(nu=cfg.nu, fx=0.7, scheme=cfg.convective_scheme)
        if cfg.bc_x == BCType.WALL:
            check(K.xpad_eligible(g, cfg), f"{label}: not an xpad grid")
            xg = K.xpad_geometry(g)
            arrays = tuple(map(_band, K.general_arrays(xg)))
            kern = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, a=arrays, g=g, kg=kg,
                    xg=xg: K.predictor_xpad(u, v, w, dt, a, geom=g, xgeom=xg,
                                            nu_t=n, **kg))
            twin = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, g=g, kg=kg, xg=xg:
                    K.predictor_xpad_twin(u, v, w, dt, n, geom=g, xgeom=xg,
                                          **kg))
        else:
            check(K.general_eligible(g, cfg), f"{label}: not a general grid")
            arrays = K.general_arrays(g)
            kern = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, a=arrays, g=g, kg=kg:
                    K.predictor_general(u, v, w, dt, a, geom=g, nu_t=n, **kg))
            twin = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, g=g, kg=kg:
                    K.predictor_general_twin(u, v, w, dt, n, geom=g, **kg))
        inputs = (u, v, w, dt, *arrays) + (() if nu_t is None else (nu_t,))
        cases.append(Case(f"predictor_general {label}", "predictor_general",
                          kern, twin, inputs))
    return cases


def _div_cases(n, dtype, device, seed):
    """A Case for each div kernel (predictor + divergence) on random
    fields: float32 at the main paths' shapes (the periodic box n^3, the
    channel n^3 and, with a random nu_t >= 0, the LES channel n x n/2 x n,
    both stretched and central as their paths are), each the first of its
    label; float64 on the periodic box n^3 and on the channel n x 3n/2 x n,
    uniform and stretched y, skew and central, scalar nu and nu_t. Each
    carries the unfused pair it stands for (`pair`: the predictor kernel,
    then the divergence kernel of its star)."""
    from cfdnn_tpu_torch import ConvectiveScheme as CS
    from cfdnn_tpu_torch import bench, velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    dts = "float64" if dtype == torch.float64 else "float32"
    cfg = bench.tgv_config(n, dts).finalize()
    g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
    u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
    dt = torch.full((), cfg.dt, dtype=dtype, device=device)
    kp = dict(geom=g, nu=cfg.nu, fx=0.0)
    cases = [Case("predictor_periodic_div", "predictor_periodic_div",
                  lambda u=u, v=v, w=w, dt=dt:
                      K.predictor_periodic_div(u, v, w, dt, **kp),
                  lambda u=u, v=v, w=w, dt=dt:
                      K.predictor_periodic_div_twin(u, v, w, dt, **kp),
                  (u, v, w, dt), g,
                  pair=lambda u=u, v=v, w=w, dt=dt, g=g: _periodic_pair(
                      u, v, w, dt, g, cfg.nu, 0.0))]
    if dtype == torch.float32:
        grids = (("", n, True, CS.CENTRAL, False),
                 ("+nu_t", n // 2, True, CS.CENTRAL, True))
    else:
        grids = tuple((f" {'stretched' if st else 'uniform'} {sc.value}"
                       + ("+nu_t" if nut else ""), 3 * n // 2, st, sc, nut)
                      for st in (False, True) for sc in (CS.SKEW, CS.CENTRAL)
                      for nut in (False, True))
    for tag, ny, stretch, scheme, with_nut in grids:
        cfg = bench.channel_config(n, dts).with_(
            Ny=ny, stretch_y=stretch, convective_scheme=scheme).finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        nu_t = (rnd((cfg.Nx, cfg.Ny, cfg.Nz)).abs() * 1e-3 if with_nut
                else None)
        dt = torch.full((), cfg.dt, dtype=dtype, device=device)
        ys = K.channel_y_arrays(g)
        kc = dict(geom=g, nu=cfg.nu, fx=-cfg.dp_dx, scheme=scheme)
        cases.append(Case(
            "predictor_channel_div" + tag, "predictor_channel_div",
            lambda u=u, v=v, w=w, dt=dt, ys=ys, n=nu_t, kc=kc:
                K.predictor_channel_div(u, v, w, dt, ys, nu_t=n, **kc),
            lambda u=u, v=v, w=w, dt=dt, ys=ys, n=nu_t, kc=kc:
                K.predictor_channel_div_twin(u, v, w, dt, *ys, n, **kc),
            (u, v, w, dt, *ys) + (() if nu_t is None else (nu_t,)), g,
            pair=lambda u=u, v=v, w=w, dt=dt, ys=ys, n=nu_t, kc=kc:
                _channel_pair(u, v, w, dt, ys, n, kc)))
    return cases


def _periodic_pair(u, v, w, dt, g, nu, fx):
    """The unfused kernels predictor_periodic_div stands for: the
    periodic predictor, then the divergence kernel of its star."""
    from cfdnn_tpu_torch.ops import kernels as K
    star = K.predictor_periodic(u, v, w, dt, hx=g.x.h, hy=g.y.h, hz=g.z.h,
                                nu=nu, fx=fx)
    return K.divergence(*star, geom=g)


def _channel_pair(u, v, w, dt, ys, nu_t, kc):
    """The unfused kernels predictor_channel_div stands for: the channel
    predictor, then the divergence kernel of its star (`kc` the div
    kernel's keywords)."""
    from cfdnn_tpu_torch.ops import kernels as K
    g = kc["geom"]
    star = K.predictor_channel(u, v, w, dt, ys, hx=g.x.h, hz=g.z.h,
                               nu=kc["nu"], fx=kc["fx"],
                               scheme=kc["scheme"], nu_t=nu_t)
    return K.divergence(*star, geom=g)


def _tile_cases(dtype, device, seed):
    """The four slab kernels that walk an (x, z) tile along y, each against
    its twin where the tile can break (float64 to 1e-14 of scale, float32
    to 1e-5): predictor_channel, scalar nu and nu_t, skew and central, on
    stretched walled-y channels of the smallest x the tile takes (nx = 8,
    nz = 6 < 32) with ny = 2 and 3 (every plane next to a wall) and on the
    ragged 12 x 70 x 40 (x and z not multiples of the 8 x 32 tile; ny + 1
    = 71 planes over several chunks); predictor_periodic (fx on u) on
    all-periodic boxes at nx = 8 with ny = 1, 2, 3 and nz = 6 (the ring's
    y wrap within one plane or two), on the ragged 12 x 70 x 40 and below
    the tile's width, 5 x 20 x 33 and 3 x 9 x 40 (the staged x wrapped
    more than once); correct and divergence on the all-periodic box, the
    duct (walled y and z), a wall-x cavity, a 2-D channel (nz = 1), and an
    nx = 5 channel, each over more than one chunk of planes, divergence
    also on a ragged periodic box over nine chunks (12 x 70 x 40) and a
    box of one y cell (12 x 1 x 40: no y term)."""
    from cfdnn_tpu_torch import BCType, Config, velocity_shapes
    from cfdnn_tpu_torch import ConvectiveScheme as CS
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"

    def rnd(shape):
        return _band(torch.randn(shape, generator=gen, dtype=dtype,
                                 device=device))

    base = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype=dts)
    cases = []
    for nx, ny, nz in ((8, 2, 6), (8, 3, 6), (12, 70, 40)):
        for scheme in (CS.SKEW, CS.CENTRAL):
            cfg = Config(**base, Nx=nx, Ny=ny, Nz=nz, stretch_y=True,
                         convective_scheme=scheme).finalize()
            g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
            u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
            nut = rnd((nx, ny, nz)).abs() * 1e-3
            dt = torch.full((), cfg.dt, dtype=dtype, device=device)
            ys = K.channel_y_arrays(g)
            kc = dict(hx=g.x.h, hz=g.z.h, nu=cfg.nu, fx=-cfg.dp_dx,
                      scheme=scheme)
            for n in (None, nut):
                cases.append(Case(
                    f"predictor_channel {nx}x{ny}x{nz} {scheme.value}"
                    + ("" if n is None else "+nu_t"), "predictor_channel",
                    lambda u=u, v=v, w=w, dt=dt, ys=ys, n=n, kc=kc:
                        K.predictor_channel(u, v, w, dt, ys, nu_t=n, **kc),
                    lambda u=u, v=v, w=w, dt=dt, ys=ys, n=n, kc=kc:
                        K.predictor_channel_twin(u, v, w, dt, *ys, n, **kc),
                    (u, v, w, dt, *ys) + (() if n is None else (n,)),
                    f64_tol=TILE_F64_TOL))
    periodic = dict(bc_y=BCType.PERIODIC, y_min=0.0, y_max=1.0)
    for nx, ny, nz in ((8, 1, 6), (8, 2, 6), (8, 3, 6), (12, 70, 40),
                       (5, 20, 33), (3, 9, 40)):
        cfg = Config(**base, Nx=nx, Ny=ny, Nz=nz, **periodic,
                     convective_scheme=CS.SKEW).finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        dt = torch.full((), cfg.dt, dtype=dtype, device=device)
        kp = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=cfg.nu, fx=-cfg.dp_dx)
        cases.append(Case(
            f"predictor_periodic {nx}x{ny}x{nz}", "predictor_periodic",
            lambda u=u, v=v, w=w, dt=dt, kp=kp:
                K.predictor_periodic(u, v, w, dt, **kp),
            lambda u=u, v=v, w=w, dt=dt, kp=kp:
                K.predictor_periodic_twin(u, v, w, dt, **kp),
            (u, v, w, dt), f64_tol=TILE_F64_TOL))
    for tag, grid in (
            ("periodic 12x20x40", dict(Nx=12, Ny=20, Nz=40, **periodic)),
            ("duct 12x20x24", dict(Nx=12, Ny=20, Nz=24, stretch_y=True,
                                   bc_z=BCType.WALL, z_min=-1.0)),
            ("wall-x 10x18x16", dict(Nx=10, Ny=18, Nz=16,
                                     bc_x=BCType.WALL)),
            ("2-D 24x20x1", dict(Nx=24, Ny=20, Nz=1, stretch_y=True)),
            ("nx5 5x20x33", dict(Nx=5, Ny=20, Nz=33, stretch_y=True)),
            ("ragged periodic 12x70x40", dict(Nx=12, Ny=70, Nz=40,
                                              **periodic)),
            ("one y cell 12x1x40", dict(Nx=12, Ny=1, Nz=40, **periodic))):
        cfg = Config(**base, **grid).finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        cases.append(Case(
            f"divergence {tag}", "divergence",
            lambda u=u, v=v, w=w, g=g: K.divergence(u, v, w, geom=g),
            lambda u=u, v=v, w=w, g=g: K.divergence_twin(u, v, w, geom=g),
            (u, v, w, g.x.inv_d, g.y.inv_d, g.z.inv_d),
            f64_tol=TILE_F64_TOL))
        if tag.startswith(("ragged", "one y")):
            continue
        p = rnd((cfg.Nx, cfg.Ny, cfg.Nz))
        dt = torch.full((), cfg.dt, dtype=dtype, device=device)
        cases.append(Case(
            f"correct {tag}", "correct",
            lambda u=u, v=v, w=w, p=p, dt=dt, g=g:
                K.correct(u, v, w, p, dt, geom=g),
            lambda u=u, v=v, w=w, p=p, dt=dt, g=g:
                K.correct_twin(u, v, w, p, dt, geom=g),
            (u, v, w, p, dt, g.x.inv_dc, g.y.inv_dc, g.z.inv_dc),
            f64_tol=TILE_F64_TOL))
    return cases


# the div kernels' edge shapes (`_div_tile_cases`): the periodic one's
# boxes (nx, ny, nz), x below a tile and over one (the two-cell high x
# halo wrapped more than once), z at and past a tile's edge (the far z
# column), one to three periodic y planes and the ragged 12 x 70 x 40 and
# 12 x 71 x 40 (the walk one plane behind across chunks); the channel
# one's (nx, ny, nz, stretched y): ny = 2 and 3 (every plane next to a
# wall), the same z and ragged shapes, nx = 8 and 9
_DIV_TILE_BOXES = ((1, 4, 6), (2, 3, 33), (3, 9, 32), (8, 1, 35),
                   (9, 2, 6), (8, 3, 33), (12, 70, 40), (12, 71, 40))
_DIV_TILE_CHANNELS = ((8, 2, 6, True), (9, 3, 32, False), (8, 3, 33, True),
                      (9, 2, 35, True), (12, 70, 40, True),
                      (12, 71, 40, False))


def _div_tile_cases(dtype, device, seed):
    """The two div kernels on their walked (x, z) tiles, each against its
    twin where the tile can break (float64 to 1e-14 of scale, float32 to
    1e-5; div also against the divergence kernel of the kernel's own
    star): predictor_periodic_div (skew, fx on u) on `_DIV_TILE_BOXES`,
    predictor_channel_div on `_DIV_TILE_CHANNELS`, skew and central,
    scalar nu and nu_t. Every input and every tensor the wrappers allocate
    lies between NaN bands (`_band`, `_banded_call`), so a read or a write
    past an array fails the case."""
    from cfdnn_tpu_torch import BCType, Config, velocity_shapes
    from cfdnn_tpu_torch import ConvectiveScheme as CS
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"

    def rnd(shape):
        return _band(torch.randn(shape, generator=gen, dtype=dtype,
                                 device=device))

    base = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype=dts)
    cases = []
    for nx, ny, nz in _DIV_TILE_BOXES:
        cfg = Config(**base, Nx=nx, Ny=ny, Nz=nz, bc_y=BCType.PERIODIC,
                     y_min=0.0, y_max=1.0,
                     convective_scheme=CS.SKEW).finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        dt = _band(torch.full((), 1e-2, dtype=dtype, device=device))
        kp = dict(geom=g, nu=cfg.nu, fx=-cfg.dp_dx)
        cases.append(Case(
            f"predictor_periodic_div {nx}x{ny}x{nz}", "predictor_periodic_div",
            lambda u=u, v=v, w=w, dt=dt, kp=kp:
                K.predictor_periodic_div(u, v, w, dt, **kp),
            lambda u=u, v=v, w=w, dt=dt, kp=kp:
                K.predictor_periodic_div_twin(u, v, w, dt, **kp),
            (u, v, w, dt), g, f64_tol=TILE_F64_TOL, banded=True))
    for nx, ny, nz, stretch in _DIV_TILE_CHANNELS:
        for scheme in (CS.SKEW, CS.CENTRAL):
            cfg = Config(**base, Nx=nx, Ny=ny, Nz=nz, stretch_y=stretch,
                         convective_scheme=scheme).finalize()
            g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
            u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
            nut = _band(rnd((nx, ny, nz)).abs() * 1e-2)
            dt = _band(torch.full((), 1e-2, dtype=dtype, device=device))
            ys = tuple(map(_band, K.channel_y_arrays(g)))
            kc = dict(geom=g, nu=cfg.nu, fx=-cfg.dp_dx, scheme=scheme)
            for n in (None, nut):
                cases.append(Case(
                    f"predictor_channel_div {nx}x{ny}x{nz} "
                    f"{'stretched' if stretch else 'uniform'} "
                    f"{scheme.value}" + ("" if n is None else "+nu_t"),
                    "predictor_channel_div",
                    lambda u=u, v=v, w=w, dt=dt, ys=ys, n=n, kc=kc:
                        K.predictor_channel_div(u, v, w, dt, ys, nu_t=n,
                                                **kc),
                    lambda u=u, v=v, w=w, dt=dt, ys=ys, n=n, kc=kc:
                        K.predictor_channel_div_twin(u, v, w, dt, *ys, n,
                                                     **kc),
                    (u, v, w, dt, *ys) + (() if n is None else (n,)), g,
                    f64_tol=TILE_F64_TOL, banded=True))
    return cases


# the closure kernels' edge shapes (`_closure_tile_cases`): (tag, grid), the
# grid's overrides of a stretched walled-y channel; the last two serve
# transport only
_CLOSURE_GRIDS = (
    ("8x2x6", dict(Nx=8, Ny=2, Nz=6)),
    ("8x3x6", dict(Nx=8, Ny=3, Nz=6)),
    ("periodic 8x2x6", dict(Nx=8, Ny=2, Nz=6, bc_y="periodic")),
    ("periodic 8x3x6", dict(Nx=8, Ny=3, Nz=6, bc_y="periodic")),
    ("ragged 12x70x40", dict(Nx=12, Ny=70, Nz=40)),
    ("nx5 5x20x33", dict(Nx=5, Ny=20, Nz=33)),
    ("nx3 periodic 3x9x40", dict(Nx=3, Ny=9, Nz=40, bc_y="periodic")),
    ("duct 16x12x20", dict(Nx=16, Ny=12, Nz=20, bc_z="wall",
                           stretch_z=True)),
    ("duct 8x3x6", dict(Nx=8, Ny=3, Nz=6, bc_z="wall")),
    ("duct 12x20x70", dict(Nx=12, Ny=20, Nz=70, bc_z="wall",
                           stretch_z=True)),
    ("walls-pin 12x20x40", dict(Nx=12, Ny=20, Nz=40, dp_dx=0.0)),
    ("box 12x20x40", dict(Nx=12, Ny=20, Nz=40, bc_y="periodic",
                          bc_z="periodic")),
)


def _closure_tile_cases(dtype, device, seed):
    """The two closure kernels on a walked (x, z) tile, nu_sgs (each
    closure) and transport (each model), against their twins where the
    tile can break (float64 to 1e-14 of scale, float32 to 1e-5): a
    stretched walled-y channel and a periodic y at nx = 8 with ny = 2 and
    3 (every plane next to a wall; the ring's planes j - 1 and j + 1 the
    same rows) and nz = 6 < 32; the ragged 12 x 70 x 40 (several chunks);
    below the tile's width, 5 x 20 x 33 and 3 x 9 x 40 (the staged x
    wrapped more than once); the duct (walled y and z) at 16 x 12 x 20, at
    8 x 3 x 6 (one z tile, both walls in it) and at 12 x 20 x 70 (three z
    tiles); transport also on the channel with dp/dx = 0 (the omega pin on
    the wall cells only) and the all-periodic box. Vreman is held by its
    nu_t^2 (the comment below)."""
    from cfdnn_tpu_torch import BCType, Config, TurbulenceModel
    from cfdnn_tpu_torch import velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    from cfdnn_tpu_torch.turbulence import les as L
    from cfdnn_tpu_torch.turbulence import transport as tr
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    base = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype=dts, stretch_y=True,
                y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0,
                turb_model=TurbulenceModel.SST)
    cases = []
    for tag, grid in _CLOSURE_GRIDS:
        kw = dict(base, **grid)
        for axis in ("bc_y", "bc_z"):
            if kw.get(axis) == "periodic":
                kw[axis] = BCType.PERIODIC
                kw["stretch_" + axis[-1]] = False
            elif axis in kw:
                kw[axis] = BCType.WALL
        cfg = Config(**kw).finalize()
        mesh = Mesh.from_config(cfg)
        g = Geometry.make(mesh, cfg, device=device)
        cell = (cfg.Nx, cfg.Ny, cfg.Nz)
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        if not tag.startswith(("walls-pin", "box")):
            les = K.les_arrays(g)
            for model in (L.SmagorinskyModel, L.WALEModel, L.VremanModel):
                kl = dict(geom=g, closure=model.closure, coeff=model.coeff)
                # Vreman's nu_t is c sqrt(B / a:a), B a sum of cancelling
                # minors: where B ~ 0 the square root magnifies B's
                # roundoff (a fused multiply-add on the card, none in the
                # twin) up to sqrt(eps) of scale, whatever computes it, so
                # its edge cases hold nu_t^2, which is B's conditioning
                # (the main-path cases of `_cases` hold nu_t itself)
                p = 2 if model is L.VremanModel else 1
                cases.append(Case(
                    f"nu_sgs {tag} {model.closure}"
                    + (" nu_t^2" if p == 2 else ""), "nu_sgs",
                    lambda u=u, v=v, w=w, a=les, kl=kl, p=p:
                        K.nu_sgs(u, v, w, a, **kl) ** p,
                    lambda u=u, v=v, w=w, kl=kl, p=p:
                        K.nu_sgs_twin(u, v, w, **kl) ** p,
                    (u, v, w, *les), f64_tol=TILE_F64_TOL))
        gs = K.transport_arrays(g)
        k = rnd(cell).abs() * 1e-2 + 1e-4
        om = rnd(cell).abs() * 10.0 + 1.0
        nu_t = rnd(cell).abs() * 1e-3
        dt = torch.full((), cfg.dt, dtype=dtype, device=device)
        fields = (u, v, w, k, om, nu_t, dt)
        for model in ("sst_nut", "sst", "komega"):
            turb = (tr.KOmegaTransport if model == "komega"
                    else tr.SSTTransport)(cfg, mesh, g)
            consts = turb.kernel_consts
            kt = dict(geom=g, model=model, c=turb.c, nu=cfg.nu,
                      om_wall=turb.om_wall)
            cases.append(Case(
                f"transport {tag} {model}", "transport",
                lambda f=fields, c=consts, a=gs, kt=kt:
                    K.transport(*f, c, a, **kt),
                lambda f=fields, c=consts, kt=kt:
                    K.transport_twin(*f, *c, **kt),
                (*fields, *consts, *gs), f64_tol=TILE_F64_TOL))
    return cases


# the general predictor and germano_pass1 on their walked (x, z) tiles
# (`_general_tile_cases`): predictor_general's edge shapes (tag, the
# grid's overrides of a stretched walled-y channel, the scheme, with nu_t)
# and germano_pass1's (tag, overrides)
_GENERAL_TILE_GRIDS = (
    ("8x2x6", dict(Nx=8, Ny=2, Nz=6), "skew", True),
    ("8x3x6", dict(Nx=8, Ny=3, Nz=6), "central", True),
    ("periodic 8x2x6", dict(Nx=8, Ny=2, Nz=6, bc_y="periodic"), "central",
     True),
    ("periodic 8x3x6", dict(Nx=8, Ny=3, Nz=6, bc_y="periodic"), "skew",
     False),
    ("ragged 12x70x40", dict(Nx=12, Ny=70, Nz=40), "skew", True),
    ("duct 12x9x31", dict(Nx=12, Ny=9, Nz=31, bc_z="wall", stretch_z=True),
     "central", True),
    ("duct 12x9x32", dict(Nx=12, Ny=9, Nz=32, bc_z="wall", stretch_z=True),
     "skew", True),
    ("duct 12x70x33", dict(Nx=12, Ny=70, Nz=33, bc_z="wall",
                           stretch_z=True), "central", False),
    ("lid-y 16x12x8", dict(Nx=16, Ny=12, Nz=8, y_min=0.0, lid_velocity=1.3),
     "skew", False),
    ("lid-z 8x10x33", dict(Nx=8, Ny=10, Nz=33, bc_y="periodic",
                           bc_z="wall", stretch_z=True), "central", True),
    ("xpad wall-x 10x7x36", dict(Nx=10, Ny=7, Nz=36, bc_x="wall",
                                 x_max=1.5, bc_y="periodic"), "skew", True),
)
_GERMANO_TILE_GRIDS = (
    ("nx3 periodic 3x9x40", dict(Nx=3, Ny=9, Nz=40, bc_y="periodic")),
    ("nx5 5x20x33", dict(Nx=5, Ny=20, Nz=33)),
    ("8x2x6", dict(Nx=8, Ny=2, Nz=6)),
    ("8x3x6", dict(Nx=8, Ny=3, Nz=6)),
    ("periodic 8x2x6", dict(Nx=8, Ny=2, Nz=6, bc_y="periodic")),
    ("periodic 8x3x6", dict(Nx=8, Ny=3, Nz=6, bc_y="periodic")),
    ("ragged 12x70x40", dict(Nx=12, Ny=70, Nz=40)),
    ("duct 16x12x20", dict(Nx=16, Ny=12, Nz=20, bc_z="wall",
                           stretch_z=True)),
    ("duct 8x3x6", dict(Nx=8, Ny=3, Nz=6, bc_z="wall")),
    ("duct 12x20x70", dict(Nx=12, Ny=20, Nz=70, bc_z="wall",
                           stretch_z=True)),
)
# the lid on z: u and v at the (lo, hi) walls of z
_LID_Z = ((0.4, -0.7), (0.0, 1.1), (0.0, 0.0))


def _general_tile_cases(dtype, device, seed):
    """predictor_general and germano_pass1 on their walked (x, z) tiles,
    each against its twin where the tile can break (float64 to 1e-14 of
    scale, float32 to 1e-5): the predictor (`_GENERAL_TILE_GRIDS`) at
    nx = 8 with ny = 2 and 3, walled and periodic y (every plane next to
    a wall; the ring's planes j - 1 and j + 1 the same rows), on the
    ragged 12 x 70 x 40 (several chunks), on ducts with nz = 31, 32 and 33
    (w's wall face k = nz written by the lane at k = nz of the last z
    tile, or, where nz fills that tile, by warp 0's lanes 0-7), with a
    lid on y and one on z (a walled z's tangential velocities), and
    through the xpad wrapper on a no-slip x; germano_pass1
    (`_GERMANO_TILE_GRIDS`) at nx = 3, 5 and 8 (the staged x wrapped more
    than once), ny = 2 and 3 walled and periodic, on the ragged 12 x 70 x
    40 and on ducts of one to three z tiles (the filter truncated at the
    walls of z). Every input and every tensor the wrappers allocate lies
    between NaN bands (`_band`, `_banded_call`), so a read or a write past
    an array fails the case."""
    import dataclasses
    from cfdnn_tpu_torch import BCType, Config, ConvectiveScheme
    from cfdnn_tpu_torch import velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"

    def rnd(shape):
        return _band(torch.randn(shape, generator=gen, dtype=dtype,
                                 device=device))

    base = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype=dts, stretch_y=True,
                y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0)

    def geometry(grid, **extra):
        kw = dict(base, **grid, **extra)
        for axis in ("bc_x", "bc_y", "bc_z"):
            if kw.get(axis) == "periodic":
                kw[axis] = BCType.PERIODIC
                kw["stretch_" + axis[-1]] = False
            elif axis in kw:
                kw[axis] = BCType.WALL
        cfg = Config(**kw).finalize()
        return cfg, Geometry.make(Mesh.from_config(cfg), cfg, device=device)

    cases = []
    for tag, grid, scheme, with_nut in _GENERAL_TILE_GRIDS:
        cfg, g = geometry(grid, convective_scheme=ConvectiveScheme(scheme))
        if tag.startswith("lid-z"):
            x, y, z = g.axes
            g = dataclasses.replace(
                g, axes=(x, y, dataclasses.replace(z, tang=_LID_Z)))
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        nu_t = (_band(rnd((cfg.Nx, cfg.Ny, cfg.Nz)).abs() * 1e-2)
                if with_nut else None)
        dt = _band(torch.full((), 1e-2, dtype=dtype, device=device))
        kg = dict(nu=cfg.nu, fx=0.7, scheme=cfg.convective_scheme)
        if tag.startswith("xpad"):
            check(K.xpad_eligible(g, cfg), f"{tag}: not an xpad grid")
            xg = K.xpad_geometry(g)
            arrays = tuple(map(_band, K.general_arrays(xg)))
            kern = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, a=arrays, g=g, kg=kg,
                    xg=xg: K.predictor_xpad(u, v, w, dt, a, geom=g, xgeom=xg,
                                            nu_t=n, **kg))
            twin = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, g=g, kg=kg, xg=xg:
                    K.predictor_xpad_twin(u, v, w, dt, n, geom=g, xgeom=xg,
                                          **kg))
        else:
            check(K.general_eligible(g, cfg), f"{tag}: not a general grid")
            arrays = tuple(map(_band, K.general_arrays(g)))
            kern = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, a=arrays, g=g, kg=kg:
                    K.predictor_general(u, v, w, dt, a, geom=g, nu_t=n, **kg))
            twin = (lambda u=u, v=v, w=w, dt=dt, n=nu_t, g=g, kg=kg:
                    K.predictor_general_twin(u, v, w, dt, n, geom=g, **kg))
        cases.append(Case(
            f"predictor_general {tag} {scheme}"
            + ("+nu_t" if with_nut else ""), "predictor_general", kern, twin,
            (u, v, w, dt, *arrays) + (() if nu_t is None else (nu_t,)),
            f64_tol=TILE_F64_TOL, banded=True))
    for tag, grid in _GERMANO_TILE_GRIDS:
        cfg, g = geometry(grid)
        check(K.germano_pass1_eligible(g), f"{tag}: not a germano grid")
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        les = tuple(map(_band, K.les_arrays(g)))
        cases.append(Case(
            f"germano_pass1 {tag}", "germano_pass1",
            lambda u=u, v=v, w=w, a=les, g=g: K.germano_pass1(u, v, w, a,
                                                               geom=g),
            lambda u=u, v=v, w=w, g=g: K.germano_pass1_twin(u, v, w, geom=g),
            (u, v, w, *les), f64_tol=TILE_F64_TOL, banded=True))
    return cases


# predictor_xpad on an inflow/outflow and an outflow x (`_xpad_cases`):
# (tag, the grid's overrides of the LES cylinder's configuration); the
# cylinder's own 256x192x32 (258 padded planes in x, z = 32: one z tile)
# and an edge shape with an odd x (11 padded planes) and nz = 32
_XPAD_GRIDS = (("les_cylinder3900", dict(Nx=256, Ny=192, Nz=32)),
               ("9x5x32", dict(Nx=9, Ny=5, Nz=32)))
# the label of the LES cylinder's own call (inflow x, skew, WALE's nu_t):
# phase_timing times it, PERF.md's row 5 sub-row
XPAD_MAIN = "predictor_general xpad inflow les_cylinder3900 skew+nu_t"


def _xpad_cases(dtype, device, seed, grids=_XPAD_GRIDS):
    """predictor_xpad (the general predictor on the ghost-padded x) on an
    INFLOW and an OUTFLOW x, with and without nu_t, skew and central, on
    `grids` (the LES cylinder's configuration, bench.les_cylinder_config,
    with the grid's overrides), each against its twin (float64 to 1e-12
    of scale, float32 to 1e-5), every input and every tensor the wrapper
    allocates between NaN bands (`_band`, `_banded_call`)."""
    from cfdnn_tpu_torch import BCType, ConvectiveScheme, bench
    from cfdnn_tpu_torch import velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"

    def rnd(shape):
        return _band(torch.randn(shape, generator=gen, dtype=dtype,
                                 device=device))

    cases = []
    for tag, grid in grids:
        for bc in ("inflow", "outflow"):
            for scheme in ("skew", "central"):
                for with_nut in (True, False):
                    cfg = bench.les_cylinder_config(
                        dtype=dts, bc_x=BCType(bc),
                        convective_scheme=ConvectiveScheme(scheme),
                        **grid).finalize()
                    g = Geometry.make(Mesh.from_config(cfg), cfg,
                                      device=device)
                    check(K.xpad_eligible(g, cfg),
                          f"xpad {bc} {tag}: not an xpad grid")
                    xg = K.xpad_geometry(g)
                    arrays = tuple(map(_band, K.general_arrays(xg)))
                    u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
                    nu_t = (_band(rnd((cfg.Nx, cfg.Ny, cfg.Nz)).abs()
                                  * 1e-2) if with_nut else None)
                    dt = _band(torch.full((), 1e-2, dtype=dtype,
                                          device=device))
                    kg = dict(geom=g, xgeom=xg, nu=cfg.nu, fx=0.7,
                              scheme=cfg.convective_scheme)
                    cases.append(Case(
                        f"predictor_general xpad {bc} {tag} {scheme}"
                        + ("+nu_t" if with_nut else ""),
                        "predictor_general",
                        lambda u=u, v=v, w=w, dt=dt, n=nu_t, a=arrays,
                        kg=kg: K.predictor_xpad(u, v, w, dt, a, nu_t=n,
                                                **kg),
                        lambda u=u, v=v, w=w, dt=dt, n=nu_t, kg=kg:
                            K.predictor_xpad_twin(u, v, w, dt, n, **kg),
                        (u, v, w, dt, *arrays)
                        + (() if nu_t is None else (nu_t,)),
                        banded=True))
    return cases


# the O4 edge grids of `_o4_cases` (float64): (tag, grid, scheme, with
# nu_t); "periodic" and "wall" name an axis's BC, a walled y is stretched
_O4_GRIDS = (
    ("box32", dict(Nx=32, Ny=32, Nz=32, bc_y="periodic"), "skew", False),
    ("box32", dict(Nx=32, Ny=32, Nz=32, bc_y="periodic"), "central", True),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), "skew", False),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), "central", False),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), "skew", True),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), "central", True),
    ("duct32x24x24", dict(Nx=32, Ny=24, Nz=24, bc_z="wall"), "central",
     False),
    ("duct32x24x24", dict(Nx=32, Ny=24, Nz=24, bc_z="wall"), "skew", True),
    ("8x2x6 periodic y", dict(Nx=8, Ny=2, Nz=6, bc_y="periodic"), "central",
     False),
    ("8x3x6", dict(Nx=8, Ny=3, Nz=6), "central", False),
    ("8x4x6 periodic y", dict(Nx=8, Ny=4, Nz=6, bc_y="periodic"), "central",
     False),
    ("8x4x6", dict(Nx=8, Ny=4, Nz=6), "skew", False),
    ("12x70x40 periodic y", dict(Nx=12, Ny=70, Nz=40, bc_y="periodic"),
     "central", False),
    ("12x70x40", dict(Nx=12, Ny=70, Nz=40), "central", True),
    ("8x4x5 periodic y", dict(Nx=8, Ny=4, Nz=5, bc_y="periodic"), "central",
     False),
    ("8x5x4 periodic y", dict(Nx=8, Ny=5, Nz=4, bc_y="periodic"), "skew",
     False),
    ("12x5x33 duct", dict(Nx=12, Ny=5, Nz=33, bc_z="wall"), "central",
     False),
)


def _o4_cases(dtype, device, seed):
    """The O4 variants of predictor_general, divergence and correct
    (space_order=4: O4 along each periodic axis of n >= 4) against their
    twins. Float64, to 1e-12 of scale, on `_O4_GRIDS`: the 32^3 box, the
    stretched channel 32x48x32 (skew and central, scalar nu and nu_t), the
    duct 32x24x24, nx = 8 with ny = 2, 3 and 4 (periodic and walled y: a
    periodic y below 4 cells stays O2), the ragged 12x70x40 (several
    chunks of planes), periodic y and z of 4 and 5 cells (the stencils'
    reads colliding across the wrap) and a duct of two z tiles. Float32,
    to 1e-5, at the O4 paths' shapes: the 128^3 box (tgv_re1600_o4: skew,
    scalar nu), the 128^3 channel (channel128_o4: central, scalar nu) and
    the 128x64x128 LES channel (les_channel_o4: central with nu_t), each
    also through the O2 kernel on the same inputs ("o2" labels: the O2
    kernels' times on the same grids). Every input of the predictor and
    every tensor its wrapper allocates lie between NaN bands."""
    import dataclasses
    from cfdnn_tpu_torch import BCType, Config, ConvectiveScheme, bench
    from cfdnn_tpu_torch import velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"

    def rnd(shape):
        return _band(torch.randn(shape, generator=gen, dtype=dtype,
                                 device=device))

    def edge_config(grid, scheme):
        kw = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4,
                  dp_dx_specified=True, dt=1e-3, adaptive_dt=False,
                  dtype=dts, y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0,
                  space_order=4, convective_scheme=ConvectiveScheme(scheme))
        for axis in ("bc_y", "bc_z"):
            periodic = grid.get(axis) == "periodic"
            kw[axis] = BCType.PERIODIC if periodic else (
                BCType.WALL if axis == "bc_y" or axis in grid
                else BCType.PERIODIC)
            kw["stretch_" + axis[-1]] = kw[axis] == BCType.WALL
        kw.update(Nx=grid["Nx"], Ny=grid["Ny"], Nz=grid["Nz"])
        return Config(**kw).finalize()

    if dtype == torch.float64:
        grids = [(tag, edge_config(grid, scheme), with_nut, False)
                 for tag, grid, scheme, with_nut in _O4_GRIDS]
    else:
        n = 128
        grids = [
            ("tgv_re1600_o4", bench.tgv_re1600_config(n, dts, space_order=4),
             False, True),
            ("channel128_o4", bench.channel_config(n, dts, space_order=4),
             False, True),
            ("les_channel_o4", bench.les_channel_config(n, dts,
                                                        space_order=4),
             True, True)]
    cases, projected = [], set()
    for tag, cfg, with_nut, beside_o2 in grids:
        cfg = cfg.finalize()
        g4 = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        check(K.general_eligible(g4, cfg) and g4.use_o4(0),
              f"O4 {tag}: not an O4 general grid")
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        cells = (cfg.Nx, cfg.Ny, cfg.Nz)
        nu_t = _band(rnd(cells).abs() * 1e-2) if with_nut else None
        p = rnd(cells)
        dt = _band(torch.full((), 1e-2, dtype=dtype, device=device))
        arrays = tuple(map(_band, K.general_arrays(g4)))
        kg = dict(nu=cfg.nu, fx=0.7, scheme=cfg.convective_scheme)
        extra = () if nu_t is None else (nu_t,)
        scheme = cfg.convective_scheme.value
        orders = ((g4, "o4"), (dataclasses.replace(g4, space_order=2), "o2")
                  ) if beside_o2 else ((g4, "o4"),)
        for g, order in orders:
            cases.append(Case(
                f"predictor_general {order} {tag} {scheme}"
                + ("+nu_t" if with_nut else ""), "predictor_general",
                lambda u=u, v=v, w=w, dt=dt, n=nu_t, a=arrays, g=g, kg=kg:
                    K.predictor_general(u, v, w, dt, a, geom=g, nu_t=n,
                                        **kg),
                lambda u=u, v=v, w=w, dt=dt, n=nu_t, g=g, kg=kg:
                    K.predictor_general_twin(u, v, w, dt, n, geom=g, **kg),
                (u, v, w, dt, *arrays, *extra), banded=True))
            # the projection once a grid
            if (tag, order) in projected:
                continue
            projected.add((tag, order))
            dens = tuple(ax.o4_den if order == "o4" and g.use_o4(a)
                         else ax.inv_d for a, ax in enumerate(g.axes))
            cases.append(Case(
                f"divergence {order} {tag}", "divergence",
                lambda u=u, v=v, w=w, g=g: K.divergence(u, v, w, geom=g),
                lambda u=u, v=v, w=w, g=g: K.divergence_twin(u, v, w,
                                                             geom=g),
                (u, v, w, *dens)))
            cases.append(Case(
                f"correct {order} {tag}", "correct",
                lambda u=u, v=v, w=w, p=p, dt=dt, g=g: K.correct(
                    u, v, w, p, dt, geom=g),
                lambda u=u, v=v, w=w, p=p, dt=dt, g=g: K.correct_twin(
                    u, v, w, p, dt, geom=g),
                (u, v, w, p, dt, *dens)))
    return cases


def _tile_cases_512(device, seed):
    """predictor_channel on channel512's grid (512^3, stretched, central,
    scalar nu), predictor_periodic on tgv512's (all periodic, skew),
    correct and divergence on tgv512's and channel512's (walled y), and
    the two div kernels on tgv512's and channel512's (each with its
    unfused pair, `pair`), float32: the 512^3 calls of the six slab
    kernels that walk an (x, z) tile, for the timing phase and for the
    variants' old-against-new yardstick (cfdnn_tpu_torch/xz_variants.py).
    Made one at a time (a generator): each holds ~2.7-4.3 GB of the
    card."""
    from cfdnn_tpu_torch import bench, velocity_shapes
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    for label, config in (
            ("predictor_channel channel512", bench.channel_config),
            ("predictor_periodic tgv512", bench.tgv_config),
            ("correct tgv512", bench.tgv_config),
            ("correct channel512", bench.channel_config),
            ("divergence tgv512", bench.tgv_config),
            ("divergence channel512", bench.channel_config),
            ("predictor_periodic_div tgv512", bench.tgv_config),
            ("predictor_channel_div channel512", bench.channel_config)):
        cfg = config(512).finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        dt = torch.full((), cfg.dt, dtype=torch.float32, device=device)
        if label.startswith("predictor_periodic_div"):
            kp = dict(geom=g, nu=cfg.nu, fx=0.0)
            yield Case(label, "predictor_periodic_div",
                       lambda u=u, v=v, w=w, dt=dt, kp=kp:
                           K.predictor_periodic_div(u, v, w, dt, **kp),
                       lambda u=u, v=v, w=w, dt=dt, kp=kp:
                           K.predictor_periodic_div_twin(u, v, w, dt, **kp),
                       (u, v, w, dt), g,
                       pair=lambda u=u, v=v, w=w, dt=dt, g=g, cfg=cfg:
                           _periodic_pair(u, v, w, dt, g, cfg.nu, 0.0))
        elif label.startswith("predictor_channel_div"):
            ys = K.channel_y_arrays(g)
            kc = dict(geom=g, nu=cfg.nu, fx=-cfg.dp_dx,
                      scheme=cfg.convective_scheme)
            yield Case(label, "predictor_channel_div",
                       lambda u=u, v=v, w=w, dt=dt, ys=ys, kc=kc:
                           K.predictor_channel_div(u, v, w, dt, ys, **kc),
                       lambda u=u, v=v, w=w, dt=dt, ys=ys, kc=kc:
                           K.predictor_channel_div_twin(u, v, w, dt, *ys,
                                                        **kc),
                       (u, v, w, dt, *ys), g,
                       pair=lambda u=u, v=v, w=w, dt=dt, ys=ys, kc=kc:
                           _channel_pair(u, v, w, dt, ys, None, kc))
        elif label.startswith("predictor_periodic"):
            kp = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=cfg.nu, fx=0.0)
            yield Case(label, "predictor_periodic",
                       lambda u=u, v=v, w=w, dt=dt, kp=kp:
                           K.predictor_periodic(u, v, w, dt, **kp),
                       lambda u=u, v=v, w=w, dt=dt, kp=kp:
                           K.predictor_periodic_twin(u, v, w, dt, **kp),
                       (u, v, w, dt))
        elif label.startswith("divergence"):
            yield Case(label, "divergence",
                       lambda u=u, v=v, w=w, g=g:
                           K.divergence(u, v, w, geom=g),
                       lambda u=u, v=v, w=w, g=g:
                           K.divergence_twin(u, v, w, geom=g),
                       (u, v, w, g.x.inv_d, g.y.inv_d, g.z.inv_d))
        elif label.startswith("predictor_channel"):
            ys = K.channel_y_arrays(g)
            kc = dict(hx=g.x.h, hz=g.z.h, nu=cfg.nu, fx=-cfg.dp_dx,
                      scheme=cfg.convective_scheme)
            yield Case(label, "predictor_channel",
                       lambda u=u, v=v, w=w, dt=dt, ys=ys, kc=kc:
                           K.predictor_channel(u, v, w, dt, ys, **kc),
                       lambda u=u, v=v, w=w, dt=dt, ys=ys, kc=kc:
                           K.predictor_channel_twin(u, v, w, dt, *ys, **kc),
                       (u, v, w, dt, *ys))
        else:
            p = rnd((cfg.Nx, cfg.Ny, cfg.Nz))
            yield Case(label, "correct",
                       lambda u=u, v=v, w=w, p=p, dt=dt, g=g:
                           K.correct(u, v, w, p, dt, geom=g),
                       lambda u=u, v=v, w=w, p=p, dt=dt, g=g:
                           K.correct_twin(u, v, w, p, dt, geom=g),
                       (u, v, w, p, dt, g.x.inv_dc, g.y.inv_dc, g.z.inv_dc))


def _xz_cases(dtype, device, seed, nx=32, small=True):
    """A Case for each xz kernel, each with the slab kernel of the same
    function on the same inputs (`slab`): first on the les_tgv640 plane,
    nx x 640 x 640 all periodic (nx = 640: the main path's cube), the
    predictor with a random nu_t >= 0 (the main path's) and without,
    nu_sgs (Smagorinsky), divergence and correct, each the first of its
    label; then, with `small`, on small grids the xz gate serves: the
    stretched walled-y channel 16x24x32 (central, nu_t; nu_sgs with
    Smagorinsky, WALE and Vreman; divergence, correct), the lid 16x12x32
    (skew, lid_velocity 1.3, scalar nu), a periodic y 16x24x32 (skew,
    nu_t; nu_sgs with WALE and Vreman) and two grids of ragged tiles over
    two y chunks: the walled stretched 12x70x40 (skew, nu_t, the three
    closures) and the periodic-y 20x67x44 (central, nu_t, Smagorinsky)."""
    import functools
    from cfdnn_tpu_torch import BCType, Config, bench, velocity_shapes
    from cfdnn_tpu_torch import ConvectiveScheme as CS
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    from cfdnn_tpu_torch.turbulence import les as L
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"
    P = functools.partial

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    coeffs = {m.closure: m.coeff for m in (L.SmagorinskyModel, L.WALEModel,
                                           L.VremanModel)}
    base = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype=dts)
    # (label tag, config, with nu_t, nu_sgs closures, divergence/correct)
    grids = [("", bench.les_tgv_config(640, dts, Nx=nx), True,
              ("smagorinsky",), True)]
    if small:
        grids += [
            (" channel central", Config(**base, Nx=16, Ny=24, Nz=32,
                                        stretch_y=True,
                                        convective_scheme=CS.CENTRAL),
             True, ("smagorinsky", "wale", "vreman"), True),
            (" lid skew", Config(**base, Nx=16, Ny=12, Nz=32, y_min=0.0,
                                 y_max=1.0, lid_velocity=1.3,
                                 convective_scheme=CS.SKEW),
             False, (), True),
            (" periodic-y skew", Config(**base, Nx=16, Ny=24, Nz=32,
                                        bc_y=BCType.PERIODIC, y_min=0.0,
                                        y_max=1.0,
                                        convective_scheme=CS.SKEW),
             True, ("wale", "vreman"), False),
            # ragged tiles (nx, nz not multiples of 8 x 32) over two
            # 64-plane chunks, walled and periodic y
            (" ragged skew", Config(**base, Nx=12, Ny=70, Nz=40,
                                    stretch_y=True,
                                    convective_scheme=CS.SKEW),
             True, ("smagorinsky", "wale", "vreman"), True),
            (" ragged periodic-y central",
             Config(**base, Nx=20, Ny=67, Nz=44, bc_y=BCType.PERIODIC,
                    y_min=0.0, y_max=1.0, convective_scheme=CS.CENTRAL),
             True, ("smagorinsky",), True)]
    cases = []
    for tag, cfg, with_nut, closures, projection in grids:
        cfg = cfg.finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        check(K.xz_eligible(g), f"xz{tag}: not an xz grid")
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        cells = (cfg.Nx, cfg.Ny, cfg.Nz)
        nut, p = rnd(cells).abs() * 1e-3, rnd(cells)
        dt = torch.full((), cfg.dt, dtype=dtype, device=device)
        gs, les = K.general_arrays(g), K.les_arrays(g)
        kg = dict(geom=g, nu=cfg.nu, fx=-cfg.dp_dx,
                  scheme=cfg.convective_scheme)
        for n in ((nut, None) if with_nut else (None,)):
            cases.append(Case(
                "predictor_general_xz" + tag + ("" if n is None else "+nu_t"),
                "predictor_general_xz",
                P(K.predictor_general_xz, u, v, w, dt, gs, nu_t=n, **kg),
                P(K.predictor_general_twin, u, v, w, dt, n, **kg),
                (u, v, w, dt, *gs) + (() if n is None else (n,)),
                slab=P(K.predictor_general, u, v, w, dt, gs, nu_t=n, **kg)))
        for closure in closures:
            kl = dict(geom=g, closure=closure, coeff=coeffs[closure])
            cases.append(Case(
                f"nu_sgs_xz{tag} {closure}", "nu_sgs_xz",
                P(K.nu_sgs_xz, u, v, w, les, **kl),
                P(K.nu_sgs_twin, u, v, w, **kl), (u, v, w, *les),
                slab=P(K.nu_sgs, u, v, w, les, **kl)))
        if projection:
            cases.append(Case(
                "divergence_xz" + tag, "divergence_xz",
                P(K.divergence_xz, u, v, w, geom=g),
                P(K.divergence_twin, u, v, w, geom=g),
                (u, v, w, g.x.inv_d, g.y.inv_d, g.z.inv_d),
                slab=P(K.divergence, u, v, w, geom=g)))
            cases.append(Case(
                "correct_xz" + tag, "correct_xz",
                P(K.correct_xz, u, v, w, p, dt, geom=g),
                P(K.correct_twin, u, v, w, p, dt, geom=g),
                (u, v, w, p, dt, g.x.inv_dc, g.y.inv_dc, g.z.inv_dc),
                slab=P(K.correct, u, v, w, p, dt, geom=g)))
    return cases


_XZ_O4_GRIDS = (
    # (tag, grid, scheme, with nu_t, nu_sgs closures, divergence/correct):
    # a stretched walled y (O2 across it), a lid, nx = 8 and 12 (the
    # smallest tiles: one wrap of a two-cell halo), ragged tiles over two
    # 64-plane chunks on a walled and a periodic y, periodic y of 4 and 5
    # cells (O4, the stencils' reads colliding across the wrap)
    ("channel", dict(Nx=16, Ny=24, Nz=32), "central", True,
     ("smagorinsky", "wale", "vreman"), True),
    ("lid", dict(Nx=16, Ny=12, Nz=32, lid=1.3), "skew", False, (), True),
    ("nx8", dict(Nx=8, Ny=5, Nz=6), "central", True, ("wale",), True),
    ("nx12 periodic-y", dict(Nx=12, Ny=6, Nz=8, bc_y="periodic"), "skew",
     True, ("smagorinsky",), True),
    ("ragged", dict(Nx=12, Ny=70, Nz=40), "skew", True,
     ("smagorinsky", "wale", "vreman"), True),
    ("ragged periodic-y", dict(Nx=20, Ny=67, Nz=44, bc_y="periodic"),
     "central", True, ("vreman",), True),
    ("periodic-y4", dict(Nx=12, Ny=4, Nz=8, bc_y="periodic"), "central",
     False, ("smagorinsky",), True),
    ("periodic-y5", dict(Nx=8, Ny=5, Nz=5, bc_y="periodic"), "central",
     True, ("wale",), True),
)


def _xz_o4_cases(dtype, device, seed, nx=32, small=True):
    """The O4 variants of the xz kernels (space_order=4), each with the O4
    slab kernel of its function on the same inputs (`slab`): first on the
    512^3 planes, nx x 512 x 512 (nx = 512: the cube), of
    tgv_re1600_o4_512 (all periodic and O4, skew, scalar nu: the main
    path's predictor, divergence and correct) with the predictor also
    central with a random nu_t >= 0 and nu_sgs_xz (Smagorinsky), and of
    channel512_o4 (a stretched walled y, central: its predictor,
    divergence and correct); then, with `small`, on `_XZ_O4_GRIDS`. With
    `small` every input and every tensor a wrapper allocates lie between
    NaN bands (`_banded_call`)."""
    import functools
    from cfdnn_tpu_torch import BCType, Config, bench, velocity_shapes
    from cfdnn_tpu_torch import ConvectiveScheme as CS
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    from cfdnn_tpu_torch.turbulence import les as L
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"
    P = functools.partial
    coeffs = {m.closure: m.coeff for m in (L.SmagorinskyModel, L.WALEModel,
                                           L.VremanModel)}
    base = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype=dts, space_order=4)
    grids = [
        ("tgv_re1600_o4_512",
         bench.tgv_re1600_config(512, dts, space_order=4, Nx=nx), False,
         ("smagorinsky",), True, "central"),
        ("channel512_o4", bench.channel_config(512, dts, space_order=4,
                                               Nx=nx),
         False, (), True, None)]
    if small:
        for tag, grid, scheme, with_nut, closures, proj in _XZ_O4_GRIDS:
            kw = dict(base, Nx=grid["Nx"], Ny=grid["Ny"], Nz=grid["Nz"],
                      convective_scheme=CS(scheme))
            if grid.get("bc_y") == "periodic":
                kw.update(bc_y=BCType.PERIODIC, y_min=0.0, y_max=1.0)
            elif "lid" in grid:
                kw.update(y_min=0.0, y_max=1.0, lid_velocity=grid["lid"])
            else:
                kw.update(stretch_y=True)
            grids.append((tag, Config(**kw), with_nut, closures, proj, None))
    cases = []
    for tag, cfg, with_nut, closures, proj, also in grids:
        cfg = cfg.finalize()
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        check(K.xz_eligible(g) and g.use_o4(0) and g.use_o4(2),
              f"xz o4 {tag}: not an O4 xz grid")
        band = _band if small else (lambda t: t)

        def rnd(shape):
            return band(torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device))

        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        cells = (cfg.Nx, cfg.Ny, cfg.Nz)
        nut, p = band(rnd(cells).abs() * 1e-3), rnd(cells)
        dt = band(torch.full((), cfg.dt, dtype=dtype, device=device))
        gs = tuple(map(band, K.general_arrays(g)))
        les = tuple(map(band, K.les_arrays(g)))
        kg = dict(geom=g, nu=cfg.nu, fx=-cfg.dp_dx)
        scheme = cfg.convective_scheme
        # (scheme, nu_t) of each predictor case: the grid's own, then on
        # the 512^3 plane of the Taylor-Green central with nu_t
        runs = [(scheme, n) for n in ((None, nut) if with_nut else (None,))]
        if also:
            runs.append((CS(also), nut))
        for sch, n in runs:
            cases.append(Case(
                f"predictor_general_xz o4 {tag} {sch.value}"
                + ("" if n is None else "+nu_t"), "predictor_general_xz",
                P(K.predictor_general_xz, u, v, w, dt, gs, nu_t=n,
                  scheme=sch, **kg),
                P(K.predictor_general_twin, u, v, w, dt, n, scheme=sch, **kg),
                (u, v, w, dt, *gs) + (() if n is None else (n,)),
                slab=P(K.predictor_general, u, v, w, dt, gs, nu_t=n,
                       scheme=sch, **kg), banded=small))
        for closure in closures:
            kl = dict(geom=g, closure=closure, coeff=coeffs[closure])
            cases.append(Case(
                f"nu_sgs_xz o4 {tag} {closure}", "nu_sgs_xz",
                P(K.nu_sgs_xz, u, v, w, les, **kl),
                P(K.nu_sgs_twin, u, v, w, **kl), (u, v, w, *les),
                slab=P(K.nu_sgs, u, v, w, les, **kl), banded=small))
        if proj:
            dens = tuple(ax.o4_den if g.use_o4(a) else ax.inv_d
                         for a, ax in enumerate(g.axes))
            cdens = tuple(ax.o4_den if g.use_o4(a) else ax.inv_dc
                          for a, ax in enumerate(g.axes))
            cases.append(Case(
                f"divergence_xz o4 {tag}", "divergence_xz",
                P(K.divergence_xz, u, v, w, geom=g),
                P(K.divergence_twin, u, v, w, geom=g), (u, v, w, *dens),
                slab=P(K.divergence, u, v, w, geom=g), banded=small))
            cases.append(Case(
                f"correct_xz o4 {tag}", "correct_xz",
                P(K.correct_xz, u, v, w, p, dt, geom=g),
                P(K.correct_twin, u, v, w, p, dt, geom=g),
                (u, v, w, p, dt, *cdens),
                slab=P(K.correct, u, v, w, p, dt, geom=g), banded=small))
    return cases


# the upwind and upwind2 grids of `_upwind_cases` (float64): (tag, the
# grid's overrides, with nu_t); "periodic" and "wall" name an axis's BC (a
# walled y or z stretched), "lid" a moving top wall of y, "lid_z" the
# walls of z moving (_LID_Z)
_UPWIND_GRIDS = (
    ("box32", dict(Nx=32, Ny=32, Nz=32, bc_y="periodic"), False),
    ("box32", dict(Nx=32, Ny=32, Nz=32, bc_y="periodic"), True),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), False),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), True),
    ("duct32x24x24", dict(Nx=32, Ny=24, Nz=24, bc_z="wall"), True),
    ("lid32x24x32", dict(Nx=32, Ny=24, Nz=32, lid=1.3), False),
    # every plane next to a wall, the two ghost planes of upwind2 reading
    # the same rows
    ("8x2x6", dict(Nx=8, Ny=2, Nz=6), True),
    ("8x3x6", dict(Nx=8, Ny=3, Nz=6), False),
    ("8x4x6", dict(Nx=8, Ny=4, Nz=6), True),
    ("periodic 8x2x6", dict(Nx=8, Ny=2, Nz=6, bc_y="periodic"), False),
    ("ragged 12x70x40", dict(Nx=12, Ny=70, Nz=40), True),
    # w's wall face by the last z tile's lane (31, 33) or by warp 0 (32);
    # at 33 the first z tile's last cells reach the high wall of z
    ("duct 12x9x31", dict(Nx=12, Ny=9, Nz=31, bc_z="wall"), True),
    ("duct 12x9x32", dict(Nx=12, Ny=9, Nz=32, bc_z="wall"), False),
    ("duct 12x70x33", dict(Nx=12, Ny=70, Nz=33, bc_z="wall"), True),
    ("lid-z 8x10x33", dict(Nx=8, Ny=10, Nz=33, bc_y="periodic",
                           bc_z="wall", lid_z=True), True),
)
# the xz kernels' small grids (float64): a stretched walled y, a lid, a
# periodic y, nx = 8 with ny = 2 and 3, ragged tiles over two 64-plane
# chunks
_UPWIND_XZ_GRIDS = (
    ("channel 16x24x32", dict(Nx=16, Ny=24, Nz=32), True),
    ("lid 16x12x32", dict(Nx=16, Ny=12, Nz=32, lid=1.3), False),
    ("periodic-y 16x24x32", dict(Nx=16, Ny=24, Nz=32, bc_y="periodic"),
     True),
    ("8x2x6", dict(Nx=8, Ny=2, Nz=6), False),
    ("8x3x6", dict(Nx=8, Ny=3, Nz=6), True),
    ("ragged 12x70x40", dict(Nx=12, Ny=70, Nz=40), True),
)
# the O4 grids (float64, space_order=4)
_UPWIND_O4_GRIDS = (
    ("box32", dict(Nx=32, Ny=32, Nz=32, bc_y="periodic"), True),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), False),
    ("channel32x48x32", dict(Nx=32, Ny=48, Nz=32), True),
    ("duct32x24x24", dict(Nx=32, Ny=24, Nz=24, bc_z="wall"), False),
    ("8x2x6", dict(Nx=8, Ny=2, Nz=6), False),
    ("8x4x5 periodic y", dict(Nx=8, Ny=4, Nz=5, bc_y="periodic"), True),
    ("12x70x40", dict(Nx=12, Ny=70, Nz=40), True),
)


def _upwind_cases(dtype, device, seed):
    """The general predictor's upwind and upwind2 variants against their
    twins, on one set of inputs a grid with the skew kernel beside them
    (the "skew" labels). Float64, to 1e-12 of scale: the slab kernel on
    `_UPWIND_GRIDS` (the 32^3 box, the stretched channel 32x48x32, the
    duct 32x24x24 and a lid, with and without nu_t; nx = 8 with ny = 2, 3
    and 4, the wall ghost planes overlapping; the ragged 12x70x40; ducts
    with nz = 31, 32 and 33; walls of z moving), the O4 variants on
    `_UPWIND_O4_GRIDS`, the xz kernels on `_UPWIND_XZ_GRIDS` (O2 and O4)
    and on the
    32x640x640 plane of les_tgv640 (with nu_t; and skew there, the path's
    scheme), each of those also against the slab kernel on the same
    inputs, and upwind through xpad on
    the LES cylinder's inflow and outflow x (256x192x32, and 9x5x32).
    Float32, to 1e-5: the call of the channel_upwind and channel_upwind2
    paths (bench.channel_config at 128^3) with skew and central beside
    it, the O4 channel at 128^3, the xz kernels on the 32x640x640 plane
    and at O4 on the 32x512x512 plane of tgv_re1600_o4_512, and xpad
    upwind on the LES cylinder's inflow x with nu_t. Every input
    and every tensor the wrappers allocate lie between NaN bands but on
    the 640 plane."""
    import dataclasses
    import functools
    from cfdnn_tpu_torch import BCType, Config, bench, velocity_shapes
    from cfdnn_tpu_torch import ConvectiveScheme as CS
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.ops.grid import Geometry
    gen = torch.Generator(device=device).manual_seed(seed)
    dts = "float64" if dtype == torch.float64 else "float32"
    P = functools.partial
    up = (CS.UPWIND, CS.UPWIND2)

    def edge_config(grid, **extra):
        kw = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4,
                  dp_dx_specified=True, dt=1e-3, adaptive_dt=False,
                  dtype=dts, y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0,
                  stretch_y=True, convective_scheme=CS.UPWIND, **extra)
        kw.update(Nx=grid["Nx"], Ny=grid["Ny"], Nz=grid["Nz"])
        if grid.get("bc_y") == "periodic":
            kw.update(bc_y=BCType.PERIODIC, stretch_y=False)
        if grid.get("bc_z") == "wall":
            kw.update(bc_z=BCType.WALL, stretch_z=True)
        if "lid" in grid:
            kw.update(y_min=0.0, lid_velocity=grid["lid"])
        return Config(**kw).finalize()

    def geometry(cfg, grid=None):
        g = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        if grid is not None and grid.get("lid_z"):
            x, y, z = g.axes
            g = dataclasses.replace(
                g, axes=(x, y, dataclasses.replace(z, tang=_LID_Z)))
        return g

    def fields(cfg, with_nut, band=_band):
        def rnd(shape):
            return band(torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device))
        u, v, w = (rnd(sh) for sh in velocity_shapes(cfg))
        # advecting velocities of either sign, and ties (adv = 0 takes the
        # backward difference): every seventh u is 0
        u.view(-1)[::7] = 0.0
        nu_t = (band(rnd((cfg.Nx, cfg.Ny, cfg.Nz)).abs() * 1e-2)
                if with_nut else None)
        dt = band(torch.full((), 1e-2, dtype=dtype, device=device))
        return u, v, w, nu_t, dt

    cases = []

    def add(label, cfg, g, with_nut, schemes, fx=0.7, band=_band,
            xz=False):
        """A case of each scheme on one set of inputs: `label` with the
        scheme's name for {scheme}; an xz case with the slab kernel
        beside it."""
        u, v, w, nu_t, dt = fields(cfg, with_nut, band)
        gs = tuple(map(band, K.general_arrays(g)))
        for sch in schemes:
            kg = dict(geom=g, nu=cfg.nu, fx=fx, scheme=sch, nu_t=nu_t)
            cases.append(Case(
                label.format(scheme=sch.value)
                + ("+nu_t" if with_nut else ""),
                "predictor_general_xz" if xz else "predictor_general",
                P(K.predictor_general_xz if xz else K.predictor_general,
                  u, v, w, dt, gs, **kg),
                P(K.predictor_general_twin, u, v, w, dt, nu_t, geom=g,
                  nu=cfg.nu, fx=fx, scheme=sch),
                (u, v, w, dt, *gs) + (() if nu_t is None else (nu_t,)),
                slab=(P(K.predictor_general, u, v, w, dt, gs, **kg)
                      if xz else None),
                banded=band is _band))

    if dtype == torch.float64:
        for tag, grid, with_nut in _UPWIND_GRIDS:
            cfg = edge_config(grid)
            g = geometry(cfg, grid)
            check(K.general_eligible(g, cfg), f"{tag}: not a general grid")
            add("predictor_general {scheme} " + tag, cfg, g, with_nut,
                up + (CS.SKEW,))
        for tag, grid, with_nut in _UPWIND_O4_GRIDS:
            cfg = edge_config(grid, space_order=4)
            g = geometry(cfg)
            check(K.general_eligible(g, cfg) and g.use_o4(0),
                  f"O4 {tag}: not an O4 general grid")
            add("predictor_general o4 {scheme} " + tag, cfg, g, with_nut,
                up + (CS.SKEW,))
        for order in (2, 4):
            for tag, grid, with_nut in _UPWIND_XZ_GRIDS:
                cfg = edge_config(grid, space_order=order)
                g = geometry(cfg)
                check(K.xz_eligible(g), f"xz {tag}: not an xz grid")
                add("predictor_general_xz " + ("o4 " if order == 4 else "")
                    + "{scheme} " + tag, cfg, g, with_nut, up + (CS.SKEW,),
                    xz=True)
    else:
        # the two paths' own call at 128^3, skew and central beside it,
        # and the O4 channel
        cfg = bench.channel_config(128, dts).finalize()
        add("predictor_general {scheme} channel 128^3", cfg, geometry(cfg),
            False, up + (CS.SKEW, CS.CENTRAL), fx=-cfg.dp_dx)
        cfg = bench.channel_config(128, dts, space_order=4).finalize()
        add("predictor_general o4 {scheme} channel128_o4", cfg,
            geometry(cfg), False, up, fx=-cfg.dp_dx)
    # the 640 plane (les_tgv640's cube at nx = 32: all periodic) through
    # the xz kernels, with nu_t; at O4 the 512 plane of tgv_re1600_o4_512
    cfg = bench.les_tgv_config(640, dts, Nx=32).finalize()
    g = geometry(cfg)
    check(K.xz_eligible(g), "the 640 plane: not an xz grid")
    add("predictor_general_xz {scheme} les_tgv640 plane", cfg, g, True,
        up + (CS.SKEW,), fx=-cfg.dp_dx, band=lambda t: t, xz=True)
    if dtype == torch.float32:
        cfg = bench.tgv_re1600_config(512, dts, space_order=4,
                                      Nx=32).finalize()
        g = geometry(cfg)
        check(K.xz_eligible(g) and g.use_o4(0), "the O4 512 plane")
        add("predictor_general_xz o4 {scheme} tgv_re1600_o4_512 plane", cfg,
            g, False, up + (CS.SKEW,), fx=0.0, band=lambda t: t, xz=True)
    # upwind through xpad on the LES cylinder's inflow and outflow x, skew
    # beside it
    grids = _XPAD_GRIDS if dtype == torch.float64 else _XPAD_GRIDS[:1]
    for tag, grid in grids:
        for bc in (("inflow", "outflow") if dtype == torch.float64
                   else ("inflow",)):
            for with_nut in ((True, False) if dtype == torch.float64
                             else (True,)):
                cfg = bench.les_cylinder_config(
                    dtype=dts, bc_x=BCType(bc), convective_scheme=CS.UPWIND,
                    **grid).finalize()
                g = geometry(cfg)
                check(K.xpad_eligible(g, cfg),
                      f"xpad {bc} {tag}: not an xpad grid")
                xg = K.xpad_geometry(g)
                gs = tuple(map(_band, K.general_arrays(xg)))
                u, v, w, nu_t, dt = fields(cfg, with_nut)
                for sch in (CS.UPWIND, CS.SKEW):
                    kg = dict(geom=g, xgeom=xg, nu=cfg.nu, fx=0.7,
                              scheme=sch)
                    cases.append(Case(
                        f"predictor_general xpad {bc} {tag} {sch.value}"
                        + ("+nu_t" if with_nut else "")
                        + ("" if sch == CS.UPWIND else " beside upwind"),
                        "predictor_general",
                        P(K.predictor_xpad, u, v, w, dt, gs, nu_t=nu_t,
                          **kg),
                        P(K.predictor_xpad_twin, u, v, w, dt, nu_t, **kg),
                        (u, v, w, dt, *gs)
                        + (() if nu_t is None else (nu_t,)),
                        banded=True))
    return cases


def fht_ops(t, modal):
    """Operations a cell of a Hartley kernel call along an axis of length
    t.N: those the function needs, not those of csrc/fht.cuh's algorithm
    (a complex FFT of N2 for each k1 group, of which the real part is
    kept: ~5 log2 N2 + 2 N1 + 6 a cell a direction, ~49 at N = 512). A
    real transform of length N by a fast algorithm takes 2.5 N log2 N
    flops (half of a complex FFT's 5 N log2 N), 2.5 log2 N a cell a
    direction; the modal pass does both directions and its scale (an add,
    a compare, a division and a multiply)."""
    one = 2.5 * math.log2(t.N)
    return 2 * one + 4 if modal else one


def _fht_cases(dtype, device, seed, split640=False):
    """A Case for each Hartley kernel call. Float64 at small shapes, every
    axis, forward, inverse and modal (random symbols with null modes), for
    N1 = 1 ... 8 with N2 forced to 32, for N2 = 64, 128, 256 (N = 64, 128,
    256 and 2048 = 8 x 256, the largest split the solver takes) and for
    the odd radices' N2 = 96, 160, 192, 224 (N1 = 1, and 480 = 5 x 96, 448
    = 2 x 224) and two forced splits outside the solver's (N2 = 40 with
    N1 = 2, N2 = 48), all but N2 = 32 also with the round trip
    inverse(forward(x)) = N x and, at N <= 256, against the dense
    reference_forward. Float32 at 512^3, every axis, random fields; the
    modal pass with the tgv512 solver's symbols on each axis and the
    channel512 solver's on its Hartley axes z and x, at 128^3 with the
    O4 symbols of tgv_re1600_o4's solver and at 512^3 with those of
    tgv_re1600_o4_512's. The first
    case of each label is the main path's. With `split640`, float32 also
    at 640^3 (N1 = 5, N2 = 128) in the main path's order with the symbols
    of les_tgv640's solver under "pallas_fft", the transform the
    reference's "auto" takes for that cell on a TPU."""
    from cfdnn_tpu_torch import bench
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.poisson import pallas_fht as P
    from cfdnn_tpu_torch.poisson.fdm import FDMPoissonSolver
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    cases = []
    ax_name = "xyz"

    def add_pass(tag, t, x, axis, inverse):
        # the yardstick is one transform in the same direction: rfft, or
        # irfft of x's spectrum (made on the first, untimed, call)
        spec = []

        def irfft(x=x, axis=axis):
            if not spec:
                spec.append(torch.fft.rfft(x, dim=axis))
            return torch.fft.irfft(spec[0], n=t.N, dim=axis)

        def rfft(x=x, axis=axis):
            return torch.fft.rfft(x, dim=axis)

        cases.append(Case(
            f"fht_pass {'inv' if inverse else 'fwd'} {ax_name[axis]}{tag}",
            "fht_pass", lambda: K.fht_pass(x, axis, t, inverse=inverse),
            lambda: P.fht_pass_twin(x, axis, t, inverse), (x, t.table),
            ops=fht_ops(t, False), library=irfft if inverse else rfft))

    def add_modal(tag, t, x, axis, lam_axis, lam_rest, thr, norm):
        # the yardstick is the round trip, as the pass is
        def rfft_irfft(x=x, axis=axis):
            return torch.fft.irfft(torch.fft.rfft(x, dim=axis), n=t.N,
                                   dim=axis)

        kw = dict(thr=thr, norm=norm)
        cases.append(Case(
            f"fht_modal {ax_name[axis]}{tag}", "fht_modal",
            lambda: K.fht_modal(x, axis, t, lam_axis, lam_rest, **kw),
            lambda: P.fht_modal_twin(x, axis, t, lam_axis, lam_rest, **kw),
            (x, t.table, lam_axis, lam_rest), ops=fht_ops(t, True),
            library=rfft_irfft))

    if dtype == torch.float64:
        splits = [(32 * n1, 32) for n1 in range(1, 9)]
        splits += [(64, 64), (128, 128), (256, 256), (2048, 256)]
        # the radix-3, 5 and 7 stages of the kernels' N2 FFT
        splits += [(96, 96), (160, 160), (192, 192), (224, 224), (480, 96),
                   (448, 224)]
        # two forced splits outside the solver's
        splits += [(80, 40), (48, 48)]
        for N, n2 in splits:
            t = P.PFHTAxis.make(N, dtype, n2=n2, device=device)
            tag = f" N1={t.N1} N2={t.N2}"
            for axis in range(3):
                shape = [12, 20, 28]
                shape[axis] = N
                x = rnd(shape)
                add_pass(tag, t, x, axis, False)
                add_pass(tag, t, x, axis, True)
                lam_axis = -rnd(N).abs()
                lam_axis[0] = 0.0
                lam_rest = -rnd([s for a, s in enumerate(shape)
                                 if a != axis]).abs()
                lam_rest.view(-1)[0] = 0.0
                add_modal(tag, t, x, axis, lam_axis, lam_rest, 1e-9,
                          0.37 / N)
                if n2 != 32 and N <= 256:
                    # (at N = 2048 the dense reference's own unreduced
                    # angles, 2 pi k n / N up to ~1.3e4, cost ~1e-12)
                    cases.append(Case(
                        f"fht_pass fwd {ax_name[axis]}{tag} vs "
                        "reference_forward", "fht_pass",
                        lambda x=x, a=axis, t=t: K.fht_pass(x, a, t),
                        lambda x=x, a=axis, t=t: P.reference_forward(x, a, t),
                        (x, t.table)))
                if n2 != 32:
                    cases.append(Case(
                        f"fht_pass round trip {ax_name[axis]}{tag} vs N x",
                        "fht_pass",
                        lambda x=x, a=axis, t=t: K.fht_pass(
                            K.fht_pass(x, a, t), a, t, inverse=True) / t.N,
                        lambda x=x: x, (x, t.table)))
        return cases
    # the main path's order: forward x, y; inverse y, x; then z
    order = ((0, False), (1, False), (1, True), (0, True), (2, False),
             (2, True))

    def add_solver(tag, cfg, x):
        s = FDMPoissonSolver(Mesh.from_config(cfg), cfg, device=device)
        # the solver's own modal axis (z) first, then its other Hartley axes
        for axis in sorted(s.fht_axes, key=lambda a: a != s.fht_axes[-1]):
            rest = [a for a in range(3) if a != axis]
            lam_rest = (s._lam_vecs[rest[0]]
                        + s._lam_vecs[rest[1]]).squeeze(axis).contiguous()
            add_modal(tag, s.tr[axis].fht, x, axis, s._dev(s.tr[axis].lam),
                      lam_rest, s._null_thr, s._norm)

    n = 512
    t = P.PFHTAxis.make(n, dtype, device=device)
    x = rnd((n, n, n))
    for axis, inverse in order:
        add_pass("", t, x, axis, inverse)
    for tag, config in ((" tgv512", bench.tgv_config),
                        (" channel512", bench.channel_config)):
        add_solver(tag, config(n, poisson_transform="pallas_fft").finalize(),
                   x)
    # the O4 symbol (the modal pass's operand) of tgv_re1600_o4's solver
    # under "pallas_fft", at its 128^3
    add_solver(" tgv_re1600_o4 128", bench.tgv_re1600_config(
        128, "float32", space_order=4,
        poisson_transform="pallas_fft").finalize(), rnd((128, 128, 128)))
    # and of tgv_re1600_o4_512's, on the 512^3 field
    add_solver(" tgv_re1600_o4_512", bench.tgv_re1600_config(
        n, "float32", space_order=4,
        poisson_transform="pallas_fft").finalize(), x)
    if split640:
        n, tag = 640, " les_tgv640"
        t = P.PFHTAxis.make(n, dtype, device=device)
        check((t.N1, t.N2) == (5, 128), f"fht N = 640: split {t.N1} x {t.N2}")
        x = rnd((n, n, n))
        for axis, inverse in order:
            add_pass(tag, t, x, axis, inverse)
        add_solver(tag, bench.les_tgv_config(
            n, "float32", poisson_transform="pallas_fft").finalize(), x)
    return cases


def own_star_div_error(got, geom, dtype):
    """(max|div - divergence kernel of the kernel's own star|, limit): the
    div output of a div kernel against the divergence kernel applied to
    that kernel's own star output, limit 1e-12 (float64) or 1e-5 (float32)
    of max|div|. The recomputed neighbour stars may contract into FMAs
    otherwise than the stored ones."""
    from cfdnn_tpu_torch.ops import kernels as K
    ref = K.divergence(*got[:3], geom=geom)
    tol = F64_TOL if dtype == torch.float64 else F32_TOL
    return (float((got[3] - ref).abs().max()),
            tol * float(ref.abs().max()))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# the two kernels that write a divergence beside their predictor's star
DIV_KERNELS = ("predictor_periodic_div", "predictor_channel_div")
# the outputs of each kernel, in the order its wrapper returns them
OUTPUTS = {"germano_pass1": ("|S|", "<L:M>", "<M:M>"),
           "divergence": ("div",), "nu_sgs": ("nu_t",),
           "divergence_xz": ("div",), "nu_sgs_xz": ("nu_t",),
           "transport": ("k", "omega", "nu_t"),
           "predictor_periodic_div": ("u*", "v*", "w*", "div"),
           "predictor_channel_div": ("u*", "v*", "w*", "div"),
           "fht_pass": ("X",), "fht_modal": ("p",)}


def compare(name, got, ref, dtype, f64_tol=F64_TOL):
    """[(output, max|kernel - twin|, limit, max|twin|)], one row for each
    output of a kernel, each held to its own twin output's scale: float64
    to f64_tol (1e-12) * max|twin|, float32 to 1e-5 * max|twin|."""
    rows = []
    for out, g, r in zip(OUTPUTS.get(name, ("u*", "v*", "w*")),
                         _as_tuple(got), _as_tuple(ref)):
        scale = float(r.abs().max())
        lim = (f64_tol if dtype == torch.float64 else F32_TOL) * scale
        rows.append((out, float((g - r).abs().max()), lim, scale))
    return rows


def _hold(case, dtype, errs):
    """Run a case's kernel and twin, check each output of the kernel
    against the twin's (and an xz kernel's against the slab kernel's of
    its function, a div kernel's div against the divergence kernel of its
    own star), record the largest error under errs[name] ([float64,
    float32]); returns the twin's outputs."""
    got = _banded_call(case) if case.banded else case.kern()
    torch.cuda.synchronize()
    ref = case.twin()
    shape = tuple(_as_tuple(ref)[0].shape)
    pair = errs.setdefault(case.name, [0.0, 0.0])
    k = 0 if dtype == torch.float64 else 1
    tol = case.f64_tol or (XZ_F64_TOL if case.slab else F64_TOL)
    # the O4 variants' errors apart too (`_o4_cases`), and the upwind
    # schemes' (`_upwind_cases`)
    o4 = (errs.setdefault("o4", {}).setdefault(case.name, [0.0, 0.0])
          if " o4 " in case.label else [0.0, 0.0])
    upwind = (errs.setdefault("upwind", {}).setdefault(case.name, [0.0, 0.0])
              if " upwind" in case.label else [0.0, 0.0])
    for out, err, lim, scale in compare(case.name, got, ref, dtype, tol):
        print(f"[kernels] {case.label} {out} {str(dtype)[6:]} "
              f"{shape}: max|d|={err:.3e} (limit {lim:.3e}, "
              f"max|twin|={scale:.3e})")
        check(err <= lim, f"{case.label} {out} {dtype}: {err} > {lim}")
        pair[k] = max(pair[k], err)
        o4[k] = max(o4[k], err)
        upwind[k] = max(upwind[k], err)
    if case.name == "germano_pass1":
        # the plane sums are fixed-order float64 partials: a second launch
        # on the same inputs gives them bit for bit
        again = case.kern()
        same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
        print(f"[kernels] {case.label} {str(dtype)[6:]} plane sums of two "
              f"launches equal bit for bit: {same}")
        check(same, f"{case.label} {dtype}: the plane sums of two launches "
              "differ")
    if case.slab is not None:
        slab = case.slab()
        for out, err, lim, scale in compare(case.name, got, slab, dtype,
                                            tol):
            print(f"[kernels] {case.label} {out} {str(dtype)[6:]} "
                  f"{shape} vs the slab kernel: max|d|={err:.3e} "
                  f"(limit {lim:.3e})")
            check(err <= lim, f"{case.label} {out} {dtype} vs "
                  f"slab: {err} > {lim}")
            vs = errs.setdefault("vs slab", {})
            vs[case.label] = max(vs.get(case.label, 0.0), err / scale)
    if case.geom is not None:
        err, lim = own_star_div_error(got, case.geom, dtype)
        print(f"[kernels] {case.label} div vs divergence of its own "
              f"star {str(dtype)[6:]}: max|d|={err:.3e} (limit "
              f"{lim:.3e})")
        check(err <= lim, f"{case.label} own-star div {dtype}: "
              f"{err} > {lim}")
    return ref


def phase_kernels(device):
    """Each kernel against its twin on each grid of the main path (the xz
    kernels' 640^3 cube and the walked slab kernels' 512^3 grids in
    phase_timing), each div kernel's div against the divergence kernel of
    its own star, each xz kernel also against the slab kernel of its
    function, the slab kernels on a walked tile also on their edge
    shapes (`_tile_cases`, `_div_tile_cases`, `_closure_tile_cases`,
    `_general_tile_cases`), the O4 variants of predictor_general,
    divergence and correct (`_o4_cases`) and of the xz kernels
    (`_xz_o4_cases`, each also against the O4 slab kernel of its
    function), germano_pass1's plane sums also over a second launch (bit
    for bit);
    returns {name: [largest float64 error, largest float32 error]}."""
    errs = {}
    for dtype, n in ((torch.float64, 32), (torch.float32, 128)):
        cases = _cases(n, dtype, device, seed=1)
        if dtype == torch.float64:
            cases += _general_cases(device, seed=1)
        cases += _div_cases(n, dtype, device, seed=1)
        cases += _fht_cases(dtype, device, seed=1, split640=True)
        cases += _xz_cases(dtype, device, seed=1)
        cases += _tile_cases(dtype, device, seed=1)
        cases += _div_tile_cases(dtype, device, seed=1)
        cases += _closure_tile_cases(dtype, device, seed=1)
        cases += _general_tile_cases(dtype, device, seed=1)
        cases += _o4_cases(dtype, device, seed=1)
        cases += _xz_o4_cases(dtype, device, seed=1)
        cases += _xpad_cases(dtype, device, seed=1)
        cases += _upwind_cases(dtype, device, seed=1)
        for case in cases:
            _hold(case, dtype, errs)
    return errs


def _ke(st):
    return 0.5 * sum(float(torch.mean(c.double() ** 2)) for c in st.velocity)


class MainPath(NamedTuple):
    """One main-path step: its case function of the port's bench.py (and
    extra config), whether it runs with CFDNN_FUSE_DIV=1, the (predictor,
    closure) of its kernel plan, the fused-divergence mode it must take,
    and each kernel's launches per step, which its run must meet exactly;
    `n` is its main width (32 is the trajectories'). A `timed_only` path
    is a yardstick that phase_timing times beside a kernel path: it runs
    no kernel that another path does not run at another width, so it has
    no main-path run and no trajectories."""
    name: str
    case: Callable
    kw: dict
    fuse_env: bool
    plan: Tuple
    fuse: object
    launches: dict
    n: int = 128
    # the trajectories' grid (config overrides of the 32-wide case), its
    # launches per step where they differ, and the config of its "off" run
    # on the card
    traj: dict = None
    traj_launches: dict = None
    off_kw: dict = None
    timed_only: bool = False
    # the steps of its main-path run; an "xz" path (its plane above the slab
    # cap) has its own trajectories (phase_xz_trajectories) and its float64
    # kernel checks in phase_kernels
    steps: int = MAIN_STEPS
    xz: bool = False
    # a main-path run to this time in chunks of TGV_CHUNK steps (the
    # validation script's run), its dissipation peak held to the DNS
    # (`check_dissipation_peak`), in place of `steps` steps
    until: float = None
    # a path whose float64 check on the card has its own phase (phase_a8)
    # in place of phase_trajectories'
    own_traj: bool = False


def _projection(predictor):
    """The projection kernels of a plan with this predictor kernel: the
    xz pair with the xz predictor, none on a non-periodic x (xpad) or
    where the predictor is plain (implicit y-diffusion), else the slab
    pair."""
    if predictor == "general_xz":
        return "xz"
    return None if predictor in (None, "xpad") else "slab"


def _paths():
    """The main-path steps: the port's bench.py rows, the Re 1600
    Taylor-Green (RK3, adaptive dt) and the LES + IBM channel at 256 wide,
    and the tgv, channel and les_channel rows with the fused divergence
    (les_ibm256 also runs with the opt-in set, to show that a body takes
    none)."""
    from cfdnn_tpu_torch import ConvectiveScheme, TurbulenceModel, bench
    dyn = dict(turb_model=TurbulenceModel.DYNAMIC_SMAGORINSKY)
    rans = ("channel", "transport")
    proj = {"divergence": 1, "correct": 1}
    ch_rans = dict(proj, predictor_channel=1, transport=1)
    pfht = dict(poisson_transform="pallas_fft")
    o4 = dict(space_order=4)
    return (
        MainPath("tgv", bench.tgv_case, {}, False, ("periodic", None), False,
                 dict(proj, predictor_periodic=1)),
        MainPath("channel", bench.channel_case, {}, False, ("channel", None),
                 False, dict(proj, predictor_channel=1)),
        MainPath("les_channel", bench.les_channel_case, {}, False,
                 ("channel", "nu_sgs"), False,
                 dict(proj, predictor_channel=1, nu_sgs=1)),
        MainPath("les_channel_dynamic", bench.les_channel_case, dyn, False,
                 ("channel", "germano_pass1"), False,
                 dict(proj, predictor_channel=1, germano_pass1=1)),
        MainPath("les_tgv", bench.les_tgv_case, {}, False,
                 ("general", "nu_sgs"), False,
                 dict(proj, predictor_general=1, nu_sgs=1)),
        MainPath("les_duct", bench.les_duct_case, {}, False,
                 ("general", "nu_sgs"), False,
                 dict(proj, predictor_general=1, nu_sgs=1)),
        MainPath("rans_channel", bench.rans_channel_case, {}, False, rans,
                 False, ch_rans),
        MainPath("rans_channel_komega", bench.rans_channel_case,
                 dict(turb_model=TurbulenceModel.KOMEGA), False, rans, False,
                 ch_rans),
        MainPath("rans_channel_earsm_wj", bench.rans_channel_case,
                 dict(turb_model=TurbulenceModel.EARSM_WJ), False, rans,
                 False, ch_rans),
        # this slice's paths
        MainPath("tgv_re1600", bench.tgv_re1600_case, {}, True,
                 ("periodic", None), "periodic",
                 dict(predictor_periodic_div=1, predictor_periodic=2,
                      divergence=2, correct=3)),
        MainPath("tgv_fused", bench.tgv_case, {}, True, ("periodic", None),
                 "periodic", dict(predictor_periodic_div=1, correct=1)),
        MainPath("channel_fused", bench.channel_case, {}, True,
                 ("channel", None), "channel",
                 dict(predictor_channel_div=1, correct=1)),
        MainPath("les_channel_fused", bench.les_channel_case, {}, True,
                 ("channel", "nu_sgs"), "channel",
                 dict(predictor_channel_div=1, nu_sgs=1, correct=1)),
        MainPath("les_ibm256", bench.les_ibm_case, {}, True,
                 ("channel", "nu_sgs"), False,
                 dict(proj, predictor_channel=1, nu_sgs=1), n=256),
        # the 512^3 rows: cuFFT ("auto"), timed beside the Hartley kernels
        # ("pallas_fft"), whose trajectories run Nx = 256 (N1 = 2) with a
        # 64-wide z and a small y (the dense basis), checked on the card
        # against the eager operators with cuFFT
        MainPath("tgv512", bench.tgv_case, {}, False, ("periodic", None),
                 False, dict(proj, predictor_periodic=1), n=512,
                 timed_only=True),
        MainPath("channel512", bench.channel_case, {}, False,
                 ("channel", None), False, dict(proj, predictor_channel=1),
                 n=512, timed_only=True),
        MainPath("tgv512_pfht", bench.tgv_case, pfht, False,
                 ("periodic", None), False,
                 dict(proj, predictor_periodic=1, fht_pass=4, fht_modal=1),
                 n=512, traj=dict(Nx=256, Ny=16, Nz=64),
                 traj_launches=dict(proj, predictor_periodic=1, fht_pass=2,
                                    fht_modal=1),
                 off_kw=dict(poisson_transform="fft")),
        MainPath("channel512_pfht", bench.channel_case, pfht, False,
                 ("channel", None), False,
                 dict(proj, predictor_channel=1, fht_pass=2, fht_modal=1),
                 n=512, traj=dict(Nx=256, Ny=24, Nz=64),
                 off_kw=dict(poisson_transform="fft")),
        # 640^3: the "xz" plan, 20 steps
        MainPath("les_tgv640", bench.les_tgv_case, {}, False,
                 ("general_xz", "nu_sgs_xz"), False,
                 dict(predictor_general_xz=1, nu_sgs_xz=1, divergence_xz=1,
                      correct_xz=1), n=640, steps=20, xz=True),
        # O4 (space_order=4): the general predictor's, divergence's and
        # correct's O4 variants; the Re 1600 Taylor-Green of
        # validation/run_tgv1600.py --order 4 (RK3, adaptive dt; no fused
        # divergence at O4), the channel and the LES channel
        MainPath("tgv_re1600_o4", bench.tgv_re1600_case, o4, False,
                 ("general", None), False,
                 dict(predictor_general=3, divergence=3, correct=3)),
        MainPath("channel128_o4", bench.channel_case, o4, False,
                 ("general", None), False, dict(proj, predictor_general=1)),
        MainPath("les_channel_o4", bench.les_channel_case, o4, False,
                 ("general", "nu_sgs"), False,
                 dict(proj, predictor_general=1, nu_sgs=1)),
        # O4 on the "xz" plan (2 Ny Nz above the slab cap): the O4 variants
        # of predictor_general_xz, divergence_xz and correct_xz; the Re
        # 1600 Taylor-Green of validation/run_tgv1600.py --N 512 --order 4
        # run to t = 12, and the 512^3 channel, timed
        MainPath("tgv_re1600_o4_512", bench.tgv_re1600_case, o4, False,
                 ("general_xz", None), False,
                 dict(predictor_general_xz=3, divergence_xz=3,
                      correct_xz=3), n=512, xz=True, until=12.0),
        MainPath("channel512_o4", bench.channel_case, o4, False,
                 ("general_xz", None), False,
                 dict(predictor_general_xz=1, divergence_xz=1,
                      correct_xz=1), n=512, timed_only=True),
        # ROADMAP A.8: the LES cylinder at Re 3900 of
        # validation/run_les_cylinder3900.py (the inflow/outflow pair with
        # the convective outlet, WALE, RK3, adaptive dt, an immersed
        # cylinder): predictor_general through xpad three times a step, the
        # projection and WALE plain, as the reference's xpad mode; and the
        # RANS channel with implicit y-diffusion (the IMEX SST transport),
        # which runs no kernel, as the reference's
        MainPath("les_cylinder3900", bench.les_cylinder_case, {}, False,
                 ("xpad", None), False, dict(predictor_general=3), n=256,
                 own_traj=True),
        MainPath("rans_channel_imex", bench.rans_channel_case,
                 dict(implicit_y_diffusion=True), False, (None, None),
                 False, {}, own_traj=True),
        # ROADMAP A.2: the momentum ladder's 128^3 channel of
        # scripts/measure_upwind.py:58-68 (laminar) with upwind and
        # upwind2: predictor_general (upwind2 on its wide window) and the
        # slab projection; their float64 trajectories on the 32x48x32
        # channel; the ladder's skew row, timed (the channel predictor)
        MainPath("channel_upwind", bench.channel_case,
                 dict(convective_scheme=ConvectiveScheme.UPWIND), False,
                 ("general", None), False, dict(proj, predictor_general=1),
                 traj=dict(Ny=48)),
        MainPath("channel_upwind2", bench.channel_case,
                 dict(convective_scheme=ConvectiveScheme.UPWIND2), False,
                 ("general", None), False, dict(proj, predictor_general=1),
                 traj=dict(Ny=48)),
        MainPath("channel_skew", bench.channel_case,
                 dict(convective_scheme=ConvectiveScheme.SKEW), False,
                 ("channel", None), False, dict(proj, predictor_channel=1),
                 timed_only=True),
    )


@contextlib.contextmanager
def timed(what):
    """Prints the wall seconds that `what` (a phase, or a path in one)
    took, for the script's time budget."""
    t0 = time.perf_counter()
    yield
    print(f"[time] {what}: {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def fuse_div_env(on):
    """CFDNN_FUSE_DIV=1 set around a Simulation's construction (which
    reads it) when `on`, and unset after."""
    if on:
        os.environ["CFDNN_FUSE_DIV"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CFDNN_FUSE_DIV", None)


def build_case(path, n, **kw):
    """(Simulation, initial State) of a main path at width n, built with its
    opt-in."""
    with fuse_div_env(path.fuse_env):
        return path.case(n, **{**path.kw, **kw})


def warm_graphs(sim, st, n):
    """sim.run(st, n) with its result dropped, on a CUDA Simulation: its
    first run captures the CUDA graphs a run of n steps replays (one
    uncaptured warm-up step each, real launches), so that a run counted
    after it is replays only. Returns the seconds it took."""
    if sim.device.type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    sim.run(st, n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _cells(sim):
    return sim.cfg.Nx * sim.cfg.Ny * sim.cfg.Nz


def _plain_nu_t(sim, st):
    """The closure's nu_t by the plain twins: nu_sgs_twin, or
    germano_pass1_twin (plane sums in float64, as the kernel's) and the
    dynamic model's epilogue."""
    from cfdnn_tpu_torch.ops import kernels as K
    from cfdnn_tpu_torch.turbulence import base, les
    comps, geom, turb = st.velocity, sim.geom, sim.turb
    if sim.kernels.closure == "nu_sgs":
        return K.nu_sgs_twin(*comps, geom=geom, closure=turb.closure,
                             coeff=turb.coeff)
    return les.germano_nu_t(*K.germano_pass1_twin(*comps, geom=geom),
                            base.filter_width(geom))


def check_initial_nu_t(path, sim, st):
    """The closure's nu_t on the initial state at full width through the
    kernel plan (check launches, made before the counted run): finite,
    >= 0 and not 0 everywhere; and, on the same grid and initial state in
    float64, equal to the plain twins' to 1e-12 * max|twin|. Float64,
    because the dynamic model's Cs^2 is ill-conditioned: each cell's
    L = box(uu) - box(u)^2 cancels the mean flow, and the plane sums of
    L:M cancel between cells, so float32 rounding (FMA-contracted in the
    kernel, not in the twin) reaches ~1e-5 of max|nu_t|."""
    name = path.name
    got = sim.turb.nu_t(st, sim)
    lo, hi = float(got.min()), float(got.max())
    print(f"[main] {name} initial nu_t float32: kernel plan in [{lo:.3e}, "
          f"{hi:.3e}], nonzero cells {int((got > 0).sum())} of "
          f"{got.numel()}")
    check(bool(torch.isfinite(got).all()) and lo >= 0.0 and hi > 0.0,
          f"{name}: initial nu_t in [{lo}, {hi}]")
    if path.xz:
        # (at 640^3 float64 is 2 GB a field: nu_sgs_xz is held to its twin
        # at float64 on the 32 x 640 x 640 plane, phase_kernels)
        return
    sim64, st64 = build_case(path, path.n, device=sim.device,
                             dtype="float64")
    check(sim64.kernels == sim.kernels, f"{name}: float64 plan "
          f"{sim64.kernels}")
    got, ref = sim64.turb.nu_t(st64, sim64), _plain_nu_t(sim64, st64)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    lim = F64_TOL * scale
    print(f"[main] {name} initial nu_t float64: kernel plan vs plain "
          f"max|d| {err:.3e} (limit {lim:.3e}, max|twin| {scale:.3e}), "
          f"nonzero cells {int((got > 0).sum())} of {got.numel()}")
    check(scale > 0.0 and err <= lim,
          f"{name}: float64 initial nu_t {err} > {lim} (max {scale})")


def check_first_transport_step(path, sim):
    """The first step's (k, omega, nu_t) of a RANS path through the kernel
    plan (check launches, made before the counted run) against the plain
    math's (use_pallas="off" on the card), float64 at full width from the
    same initial state, each to 1e-12 * max|plain|."""
    from cfdnn_tpu_torch import Simulation
    name = path.name
    sim64, st = build_case(path, path.n, device=sim.device, dtype="float64")
    check(sim64.kernels == sim.kernels, f"{name}: float64 plan "
          f"{sim64.kernels}")
    off = Simulation(sim64.cfg.with_(use_pallas="off"), device=sim.device)
    got, got_nut = sim64.turb.advance_and_nu_t(st, sim64, st.dt_prev)
    ref, ref_nut = off.turb.advance_and_nu_t(st, off, st.dt_prev)
    for out, g, r in (("k", got.k, ref.k), ("omega", got.omega, ref.omega),
                      ("nu_t", got_nut, ref_nut)):
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        lim = F64_TOL * scale
        print(f"[main] {name} first step {out} float64: kernel plan vs "
              f"plain max|d| {err:.3e} (limit {lim:.3e}, max|plain| "
              f"{scale:.3e})")
        check(scale > 0.0 and err <= lim,
              f"{name}: first-step {out} {err} > {lim} (max {scale})")


def _inside_body_u(sim, st):
    """max |u| at the u faces inside the cylinder less its forcing band
    (tests/test_ibm.py:79-93), and max |u| overall."""
    import numpy as np
    body, mesh = sim.ibm.body, sim.mesh
    # the u faces the state holds: Nx on a periodic x, Nx + 1 on a bounded
    X = mesh.x.faces[:st.u.shape[0]][:, None]
    Y = mesh.y.centers[None, :]
    inside = np.sqrt((X - body.cx) ** 2 + (Y - body.cy) ** 2) < (
        body.radius - sim.ibm.band)
    check(bool(inside.any()), "les_ibm256: no u face inside the body")
    mask = torch.as_tensor(inside, device=st.u.device)
    return float(st.u[mask].abs().max()), float(st.u.abs().max())


def _plane_flux(sim, plane):
    """The area-weighted mean of a u plane (float64; the (y, z) cell
    areas of the reference's _yz_area_weights)."""
    import numpy as np
    w = np.outer(sim.mesh.y.d, sim.mesh.z.d)
    w = torch.as_tensor(w / w.sum(), device=plane.device)
    return float(torch.sum(plane.double() * w))


def check_inflow(name, sim, st, profile):
    """After a run of the inflow/outflow pair: u's inlet face equal to the
    profile `initialize` captured, bit for bit; one more step of the loop
    with the outlet's flux anchor observed (`_anchor_outlet_flux`, before
    each projection), the outlet face's area-weighted flux equal to the
    inlet's there to 1e-5 relative in each stage. (After the projection
    they differ by the divergence the IBM forcing leaves in the solid,
    whose Poisson rhs is masked: printed, as the reference has it.) Then a
    second `initialize` with the inlet profile scaled by 1.5 is pinned by
    the replayed graphs (16 steps of `run`, the graphs captured before)."""
    q_in, q_out = _plane_flux(sim, st.u[0]), _plane_flux(sim, st.u[-1])
    same = torch.equal(st.u[0], profile[0])
    print(f"[main] {name} inlet face equal to the captured profile bit for "
          f"bit: {same}; after the step's last projection and IBM forcing "
          f"flux in {q_in:.9e}, out {q_out:.9e} (relative d "
          f"{abs(q_out / q_in - 1):.3e}: the solid's divergence)")
    check(same, f"{name}: the inlet face is not the captured profile")
    anchored = []
    anchor = sim._anchor_outlet_flux

    def observed(comps):
        out = anchor(comps)
        anchored.append((_plane_flux(sim, out[0][0]),
                         _plane_flux(sim, out[0][-1])))
        return out

    sim._anchor_outlet_flux = observed
    try:
        sim._run_loop(st, 1, True)
    finally:
        del sim._anchor_outlet_flux
    worst = max(abs(o / i - 1) for i, o in anchored)
    print(f"[main] {name} the outlet's flux anchor in {len(anchored)} "
          f"stages of a step: outlet flux / inlet flux - 1 at most "
          f"{worst:.3e} (limit 1e-5)")
    check(len(anchored) > 0 and worst <= 1e-5,
          f"{name}: anchored fluxes {anchored}")
    graphs = dict(sim._graphs)
    u1 = st.u.clone()
    u1[0] *= 1.5
    st1 = sim.initialize(st.replace(u=u1))
    check(sim._graphs == graphs, f"{name}: a second initialize dropped the "
          "graphs")
    st1, _ = sim.run(st1, 16)
    torch.cuda.synchronize()
    same = torch.equal(st1.u[0], 1.5 * profile[0])
    print(f"[main] {name} second initialize (inlet x 1.5): 16 steps by the "
          f"graphs captured before, inlet face the new profile bit for "
          f"bit: {same}")
    check(same and sim._graphs == graphs,
          f"{name}: the replayed graphs did not pin the new profile")


def check_imex(name, st):
    """After a run with implicit y-diffusion and a k-omega closure: k and
    omega > 0 and nu_t >= 0, finite, nu_t not 0 everywhere."""
    extra = []
    for field, f in (("k", st.k), ("omega", st.omega), ("nu_t", st.nu_t)):
        if f is None:
            continue
        lo, hi = float(f.min()), float(f.max())
        extra.append(f"{field} in [{lo:.3e}, {hi:.3e}]")
        check(bool(torch.isfinite(f).all()) and hi > 0.0
              and (lo >= 0.0 if field == "nu_t" else lo > 0.0),
              f"{name}: {field} in [{lo}, {hi}]")
    print(f"[main] {name} after the run: {', '.join(extra)}")


def check_adaptive_dt(name, sim, st):
    """Two more steps (after the counted run): each step's dt is within the
    CFL and diffusion bound of the state it starts from (the reference's
    _adaptive_dt, solver.py:928-951), and the two differ."""
    cfg, mesh = sim.cfg, sim.mesh
    dts = []
    for _ in range(2):
        vmax = [max(float(c.abs().max()), 1e-30) for c in st.velocity]
        bound = cfg.dt_safety * min(
            cfg.CFL_xz * mesh.x.d.min() / vmax[0],
            cfg.CFL_max * mesh.y.d.min() / vmax[1],
            cfg.CFL_xz * mesh.z.d.min() / vmax[2],
            0.25 / (cfg.nu * (mesh.x.d.min() ** -2 + mesh.y.d.min() ** -2
                              + mesh.z.d.min() ** -2)))
        st, d = sim.step(st)
        dt = float(d.dt)
        print(f"[main] {name} adaptive dt {dt:.9e} (bound {bound:.9e})")
        check(0.0 < dt <= bound * (1.0 + 1e-5),
              f"{name}: dt {dt} outside (0, {bound}]")
        dts.append(dt)
    check(dts[0] != dts[1], f"{name}: dt did not change ({dts})")


# the run to t = 12 of tgv_re1600_o4_512 (validation/run_tgv1600.py): runs
# of TGV_CHUNK steps, KE read off each run's diagnostics, eps = -dKE/dt by
# np.gradient; the canonical 512^3 spectral DNS of the Re 1600
# Taylor-Green (van Rees et al., J. Comput. Phys. 230 (2011) 2794) peaks
# at eps ~ 0.0127 near t ~ 9: the run's peak must lie in EPS_PEAK and its
# time in T_PEAK
TGV_CHUNK = 20
DNS_EPS_PEAK, DNS_T_PEAK = 0.0127, 9.0
EPS_PEAK = (0.0120, 0.0136)
T_PEAK = (8.4, 9.6)


def run_until(sim, st, until):
    """sim.run in chunks of TGV_CHUNK steps until t >= until: (State,
    diagnostics, steps, times, kinetic energies), the first time and
    energy the initial state's."""
    ts, kes, steps = [float(st.t)], [_ke(st)], 0
    while ts[-1] < until:
        st, d = sim.run(st, TGV_CHUNK)
        steps += TGV_CHUNK
        ts.append(float(st.t))
        kes.append(float(d.ke))
        check(math.isfinite(kes[-1]), f"KE {kes[-1]} at t = {ts[-1]}")
    return st, d, steps, ts, kes


def check_dissipation_peak(name, ts, kes):
    """The dissipation rate eps = -dKE/dt of the series (np.gradient, as
    the validation script takes it): its peak within EPS_PEAK, at a time
    within T_PEAK."""
    import numpy as np
    t, ke = np.asarray(ts), np.asarray(kes)
    eps = -np.gradient(ke, t)
    i = int(np.argmax(eps))
    print(f"[main] {name} series: " + json.dumps(
        {"t": [round(x, 6) for x in t.tolist()],
         "ke": [round(x, 9) for x in ke.tolist()]}))
    print(f"[main] {name} dissipation peak eps = {eps[i]:.6f} at t = "
          f"{t[i]:.4f} (the 512^3 spectral DNS, van Rees et al. 2011: "
          f"{DNS_EPS_PEAK} at t ~ {DNS_T_PEAK}); KE {ke[0]:.6f} -> "
          f"{ke[-1]:.6f} at t = {t[-1]:.4f}")
    check(EPS_PEAK[0] <= eps[i] <= EPS_PEAK[1]
          and T_PEAK[0] <= t[i] <= T_PEAK[1],
          f"{name}: dissipation peak {eps[i]} at t = {t[i]}, outside "
          f"{EPS_PEAK} x {T_PEAK}")


def phase_main_path(device):
    """Drive each main-path step at its benchmark size through
    Simulation.run; returns the launch counts of the kernels summed over
    the runs, each path's divergence and {kernel: {path: launches per
    step}}."""
    from cfdnn_tpu_torch import velocity_shapes
    from cfdnn_tpu_torch.ops import kernels as K
    total = {k.__name__: 0 for k in K.KERNELS}
    per_step = {k.__name__: {} for k in K.KERNELS}
    out = {}
    for path in _paths():
        if path.timed_only:
            continue
        name, (predictor, closure) = path.name, path.plan
        t0 = time.perf_counter()
        sim, st = build_case(path, path.n, device=device)
        built = time.perf_counter() - t0
        projection = _projection(predictor)
        check(sim.kernels.predictor == predictor
              and sim.kernels.projection == projection
              and sim.kernels.closure == closure
              and sim._fuse_div == path.fuse,
              f"{name}: kernel plan {sim.kernels}, fused div "
              f"{sim._fuse_div}")
        ke0 = _ke(st)
        if not path.fuse_env or sim.ibm is not None:
            # (a fused path's closure input is its unfused path's)
            if closure == "transport":
                check_first_transport_step(path, sim)
            elif closure:
                check_initial_nu_t(path, sim, st)
        profile = (None if sim._inflow_profile is None
                   else tuple(p.clone() for p in sim._inflow_profile))
        capture = warm_graphs(sim, st,
                              path.steps if path.until is None else TGV_CHUNK)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        if path.until is None:
            steps = path.steps
            st, d = sim.run(st, steps)
        else:
            st, d, steps, ts, kes = run_until(sim, st, path.until)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        counts = K.launch_counts()
        for k, c in counts.items():
            check(c == steps * path.launches.get(k, 0),
                  f"{name}: {k} launched {c} times in {steps} steps")
            total[k] += c
            if c:
                per_step[k][name] = c / steps
        for comp, shape in zip(st.velocity, velocity_shapes(sim.cfg)):
            check(tuple(comp.shape) == shape, f"{name}: shape {comp.shape}")
            check(bool(torch.isfinite(comp).all()), f"{name}: non-finite")
        ke, div = float(d.ke), float(d.div_linf)
        check(math.isfinite(ke), f"{name}: KE {ke}")
        check(div <= 1e-3, f"{name}: div_linf {div} > 1e-3")
        if name in ("tgv", "les_tgv", "tgv_re1600", "tgv_fused",
                    "tgv512_pfht", "les_tgv640", "tgv_re1600_o4",
                    "tgv_re1600_o4_512"):
            check(ke < ke0, f"{name}: KE {ke} did not decay from {ke0}")
        extra = ""
        if closure:
            nut = st.nu_t
            check(bool(torch.isfinite(nut).all()), f"{name}: nu_t non-finite")
            lo, hi = float(nut.min()), float(nut.max())
            check(lo >= 0.0, f"{name}: nu_t in [{lo}, {hi}]")
            extra = f", nu_t in [{lo:.3e}, {hi:.3e}]"
        if closure in ("nu_sgs", "transport"):
            check(hi > 0.0, f"{name}: nu_t is 0 everywhere")
        if closure == "transport":
            for field, f in (("k", st.k), ("omega", st.omega)):
                lo_f, hi_f = float(f.min()), float(f.max())
                check(bool(torch.isfinite(f).all()) and lo_f > 0.0,
                      f"{name}: {field} in [{lo_f}, {hi_f}]")
                extra += f", {field} in [{lo_f:.3e}, {hi_f:.3e}]"
        elif closure == "germano_pass1":
            # Cs^2 = clip(<L:M>/<M:M>, 0, 0.5) is 0 in every plane whose
            # <L:M> < 0, which from this random start is most planes (all
            # of them at times): nu_t may be 0 everywhere. What must hold
            # is the model's input: |S| > 0 somewhere, <M:M> > 0 and
            # <L:M> finite in every plane (a check launch, not counted).
            smag, lm, mm = K.germano_pass1(*st.velocity, sim.les_arrays,
                                           geom=sim.geom)
            check(float(smag.max()) > 0.0 and bool((mm > 0).all())
                  and bool(torch.isfinite(lm).all()),
                  f"{name}: |S| max {float(smag.max())}, <M:M> min "
                  f"{float(mm.min())}, <L:M> finite "
                  f"{bool(torch.isfinite(lm).all())}")
            extra += (f", planes with <L:M> > 0: {int((lm > 0).sum())} of "
                      f"{lm.numel()}")
        if sim.ibm is not None:
            fx, fy = float(d.fx), float(d.fy)
            check(math.isfinite(fx) and math.isfinite(fy),
                  f"{name}: fx {fx}, fy {fy}")
            u_in, u_max = _inside_body_u(sim, st)
            check(u_in < 0.05 * u_max,
                  f"{name}: |u| {u_in} inside the body, max {u_max}")
            extra += (f", fx {fx:.6e}, fy {fy:.6e}, fz {float(d.fz):.6e}, "
                      f"max|u| inside the body {u_in:.3e} of {u_max:.3e}")
        grid = "x".join(str(a) for a in (sim.cfg.Nx, sim.cfg.Ny, sim.cfg.Nz))
        print(f"[main] {name} {grid} float32 (built in {built:.2f} s, "
              f"graphs captured in {capture:.2f} s) {steps} steps in "
              f"{wall:.2f} s: launches {counts}, "
              f"KE {ke0:.6e} -> {ke:.6e}, "
              f"div_linf {div:.3e}{extra}, t {float(st.t):.6f}, "
              f"dt {float(d.dt):.6e}, peak device memory {peak_gb:.2f} GB")
        if path.until is not None:
            check_dissipation_peak(name, ts, kes)
        if profile is not None:
            check_inflow(name, sim, st, profile)
        if sim.cfg.implicit_y_diffusion:
            check_imex(name, st)
        if sim.cfg.adaptive_dt:
            check_adaptive_dt(name, sim, st)
        out[name] = (div, steps)
    return total, out, per_step


def phase_trajectories(device):
    """32^3 (the LES and RANS channels and the fused channel 32x24x32, the
    LES + IBM channel 32x16x32) float64, 20 steps from one initial state:
    kernels on the card vs the eager operators on the card and on the
    CPU."""
    import numpy as np
    from cfdnn_tpu_torch import State, state_to_numpy
    from cfdnn_tpu_torch.ops import kernels as K
    for path in _paths():
        if path.timed_only or path.xz or path.own_traj:
            continue
        kw = path.traj or {}
        if (path.case.__name__ in ("les_channel_case", "rans_channel_case")
                or path.name == "channel_fused"):
            kw = dict(Ny=24)
        sim_k, st0 = build_case(path, 32, device=device, dtype="float64",
                                **kw)
        check(sim_k.kernels.predictor is not None
              and sim_k._fuse_div == path.fuse,
              f"{path.name}: plan {sim_k.kernels}, {sim_k._fuse_div}")
        per_step = sum((path.traj_launches or path.launches).values())
        finals = {}
        for label, dev, mode in (("kernels", device, "auto"),
                                 ("off", device, "off"),
                                 ("cpu", "cpu", "off")):
            extra = (path.off_kw or {}) if label == "off" else {}
            sim = sim_k if label == "kernels" else build_case(
                path, 32, device=dev, dtype="float64", use_pallas=mode,
                **kw, **extra)[0]
            st = State(**{k: (None if v is None else v.to(dev))
                          for k, v in vars(st0).items()})
            warm_graphs(sim, st, 20)
            K.reset_launch_counts()
            fin, _ = sim.run(st, 20)
            n = sum(K.launch_counts().values())
            check(n == (20 * per_step if label == "kernels" else 0),
                  f"{path.name} {label}: launches {K.launch_counts()}")
            finals[label] = state_to_numpy(fin)
        keys = [k for k in ("u", "v", "w", "p", "k", "omega", "nu_t")
                if k in finals["kernels"]]
        for label in ("off", "cpu"):
            err = max(float(np.max(np.abs(finals["kernels"][k]
                                          - finals[label][k])))
                      for k in keys)
            grid = "x".join(str(a) for a in (sim_k.cfg.Nx, sim_k.cfg.Ny,
                                             sim_k.cfg.Nz))
            print(f"[traj] {path.name} {grid} float64 20 steps, kernels vs "
                  f"{label} ({', '.join(keys)}): max|d| = {err:.3e}")
            check(err <= TRAJ_TOL, f"{path.name} vs {label}: {err}")


def phase_xz_trajectories(device):
    """20 float64 steps in forced "xz" (the port's SLAB_FIT_CELLS lowered
    while the Simulation is built, as tests/test_torch_xz.py lowers it):
    the LES Taylor-Green at 32x32x64 and the stretched channel at 32x24x64,
    and at O4 (space_order=4: the O4 xz variants) the Taylor-Green, the
    channel and the central LES Taylor-Green on the same grids,
    the kernels on the card against the eager operators on the CPU from
    the same initial state, u, v, w and nu_t to 1e-12 of each one's scale,
    p to 1e-12 of the larger of its own and the velocity's scale; each
    step launches the xz kernels once each and nothing else."""
    import numpy as np
    from cfdnn_tpu_torch import ConvectiveScheme, State, bench, state_to_numpy
    from cfdnn_tpu_torch import solver as S
    from cfdnn_tpu_torch.ops import kernels as K
    xz = ("predictor_general_xz", "divergence_xz", "correct_xz")
    o4 = dict(space_order=4)
    central = dict(convective_scheme=ConvectiveScheme.CENTRAL)
    for name, case, kw, launches in (
            ("les_tgv", bench.les_tgv_case, dict(Nz=64), xz + ("nu_sgs_xz",)),
            ("channel", bench.channel_case, dict(Ny=24, Nz=64), xz),
            # O4: the O4 xz variants (the LES Taylor-Green central: the
            # predictor's O4 variant with nu_t)
            ("tgv o4", bench.tgv_case, dict(Nz=64, **o4), xz),
            ("channel o4", bench.channel_case, dict(Ny=24, Nz=64, **o4), xz),
            ("les_tgv o4", bench.les_tgv_case, dict(Nz=64, **o4, **central),
             xz + ("nu_sgs_xz",))):
        cap = S.SLAB_FIT_CELLS
        S.SLAB_FIT_CELLS = 8
        try:
            sim, st0 = case(32, device=device, dtype="float64", **kw)
        finally:
            S.SLAB_FIT_CELLS = cap
        check(sim.kernels.projection == "xz",
              f"xz {name}: plan {sim.kernels}")
        cpu = case(32, device="cpu", dtype="float64", use_pallas="off",
                   **kw)[0]
        finals = {}
        for label, s in (("kernels", sim), ("cpu", cpu)):
            st = State(**{k: (None if v is None else v.to(s.device))
                          for k, v in vars(st0).items()})
            warm_graphs(s, st, 20)
            K.reset_launch_counts()
            fin, _ = s.run(st, 20)
            counts = K.launch_counts()
            want = {k: (20 if label == "kernels" and k in launches else 0)
                    for k in counts}
            check(counts == want, f"xz {name} {label}: launches {counts}")
            finals[label] = state_to_numpy(fin)
        grid = "x".join(str(a) for a in (sim.cfg.Nx, sim.cfg.Ny, sim.cfg.Nz))
        scales = {k: float(np.max(np.abs(finals["cpu"][k])))
                  for k in ("u", "v", "w", "p", "nu_t") if k in finals["cpu"]}
        for k, scale in scales.items():
            err = float(np.max(np.abs(finals["kernels"][k]
                                      - finals["cpu"][k])))
            # the pressure solves div(u*) / dt: its roundoff is the
            # velocity's over dt, not its own (0.05 on the near-steady
            # channel), so it is held to the larger of its own and the
            # velocity's scale
            lim = 1e-12 * (max(scale, scales["u"], scales["v"], scales["w"])
                           if k == "p" else scale)
            print(f"[traj] xz {name} {grid} float64 20 steps {k}, kernels "
                  f"vs cpu: max|d| = {err:.3e} ({err / scale:.2e} of its "
                  f"scale {scale:.3e}; limit {lim:.3e})")
            check(err <= lim, f"xz {name} {k}: {err} > {lim}")


# the 2-D Re 100 external cylinder of validation/run_cylinder_strouhal.py
# (:43-108): its driver's gate on the Strouhal number (the reference
# measured 0.172 there; published ~0.165), its 12000-step transient and
# 1200 samples of Cl, 10 steps apart
ST_GATE = (0.15, 0.18)
RE100_TRANSIENT, RE100_SAMPLES, RE100_STRIDE = 12000, 1200, 10


def _steps_vs(sims, st0, steps, what):
    """{label: (final numpy State, launches)} of `steps` steps of each
    (label, Simulation) from copies of st0 on its device."""
    from cfdnn_tpu_torch import State, state_to_numpy
    from cfdnn_tpu_torch.ops import kernels as K
    out = {}
    for label, sim in sims:
        st = State(**{k: (None if v is None else v.to(sim.device))
                      for k, v in vars(st0).items()})
        warm_graphs(sim, st, steps)
        K.reset_launch_counts()
        fin, _ = sim.run(st, steps)
        out[label] = (state_to_numpy(fin),
                      {k: c for k, c in K.launch_counts().items() if c})
        print(f"[a8] {what} {label} ({sim.device}, {sim.kernels}): "
              f"launches {out[label][1]}")
    return out


def _scaled_errors(what, a, b, tol):
    """Each field of two numpy States held to tol of its scale; p, as in
    phase_xz_trajectories, to tol of the larger of its own and the
    velocity's scale (it solves div(u*) / dt: its roundoff is the
    velocity's, and a near-steady p is small beside it)."""
    import numpy as np
    scales = {k: float(np.max(np.abs(b[k])))
              for k in ("u", "v", "w", "p", "k", "omega", "nu_t") if k in a}
    for k, scale in scales.items():
        err = float(np.max(np.abs(a[k] - b[k])))
        lim = tol * (max(scale, scales["u"], scales["v"], scales["w"])
                     if k == "p" else scale)
        print(f"[a8] {what} {k}: max|d| = {err:.3e} ({err / scale:.2e} of "
              f"its scale {scale:.3e}; limit {lim:.3e})")
        check(err <= lim, f"{what} {k}: {err} > {lim}")


def phase_a8(device):
    """ROADMAP A.8 on the card beyond the main paths: (1) the LES
    cylinder in float64 at 64x48x16, 20 steps, the kernels (predictor_general
    through xpad, three a step) against use_pallas="off" on the card, each
    field to 1e-12 of its scale; (2) rans_channel_imex (SST, implicit
    y-diffusion: no kernel) in float64 at 32x24x32, 20 steps on the card
    against the CPU, each field to 1e-12 of its scale (p of the larger of
    its own and the velocity's, `_scaled_errors`); (3) the 2-D Re 100
    external cylinder of validation/run_cylinder_strouhal.py (384x256,
    dt 5e-3, float32, the inflow/outflow pair without the convective
    outlet): 12000 steps of transient, then Cl sampled every 10 steps for
    12000 more, the Strouhal number from its upward zero crossings within
    ST_GATE, with the Cl amplitude and the seconds it took."""
    import numpy as np
    from cfdnn_tpu_torch import bench
    from cfdnn_tpu_torch.solver import KernelPlan
    with timed("a8 les_cylinder float64"):
        grid = dict(Nx=64, Ny=48, Nz=16)
        sim_k, st0 = bench.les_cylinder_case(64, device=device,
                                             dtype="float64", **grid)
        check(sim_k.kernels == KernelPlan("xpad", None, None),
              f"les_cylinder float64: plan {sim_k.kernels}")
        off = bench.les_cylinder_case(64, device=device, dtype="float64",
                                      use_pallas="off", **grid)[0]
        res = _steps_vs((("kernels", sim_k), ("off", off)), st0, 20,
                        "les_cylinder 64x48x16 float64 20 steps")
        check(res["kernels"][1] == {"predictor_general": 60}
              and res["off"][1] == {}, f"les_cylinder float64 launches "
              f"{res['kernels'][1]}, {res['off'][1]}")
        _scaled_errors("les_cylinder 64x48x16 float64 kernels vs off",
                       res["kernels"][0], res["off"][0], F64_TOL)
    with timed("a8 rans_channel_imex float64"):
        kw = dict(Ny=24, implicit_y_diffusion=True)
        sim_c, st0 = bench.rans_channel_case(32, device=device,
                                             dtype="float64", **kw)
        check(sim_c.kernels == KernelPlan(None, None, None),
              f"rans_channel_imex float64: plan {sim_c.kernels}")
        cpu = bench.rans_channel_case(32, device="cpu", dtype="float64",
                                      **kw)[0]
        res = _steps_vs((("card", sim_c), ("cpu", cpu)), st0, 20,
                        "rans_channel_imex 32x24x32 float64 20 steps")
        check(res["card"][1] == {} and res["cpu"][1] == {},
              "rans_channel_imex: a kernel launched")
        _scaled_errors("rans_channel_imex 32x24x32 float64 card vs cpu",
                       res["card"][0], res["cpu"][0], F64_TOL)
    with timed("a8 cylinder_re100_2d"):
        from cfdnn_tpu_torch.apps import cylinder
        cfg = cylinder.external_config().with_(convective_outflow=False)
        sim = bench.Simulation(cfg, device=device)
        sim.set_ibm_forcing(cylinder.make_body_external(cfg, sim.mesh))
        st = sim.initialize(cylinder.external_ic(cfg, sim.mesh,
                                                 device=device))
        t0 = time.perf_counter()
        st, d = sim.run(st, RE100_TRANSIENT)
        check(math.isfinite(float(d.ke)), "cylinder_re100_2d: blow-up in "
              "the transient")
        t, cl = [], []
        for _ in range(RE100_SAMPLES):
            st, d = sim.run(st, RE100_STRIDE)
            t.append(float(st.t))
            cl.append(float(d.fy) / 0.5)     # q A = 0.5 U^2 D, U = D = 1
        seconds = time.perf_counter() - t0
        cl = np.asarray(cl) - np.mean(cl)
        t = np.asarray(t)
        up = np.where((cl[:-1] < 0) & (cl[1:] >= 0))[0]
        check(len(up) >= 5, f"cylinder_re100_2d: {len(up)} shedding periods")
        st_num = 1.0 / ((t[up[-1]] - t[up[0]]) / (len(up) - 1))
        amp = float(np.max(np.abs(cl)))
        steps = RE100_TRANSIENT + RE100_SAMPLES * RE100_STRIDE
        print(f"[a8] cylinder_re100_2d 384x256 float32 {steps} steps in "
              f"{seconds:.2f} s ({seconds / steps * 1e3:.4f} ms/step): St "
              f"{st_num:.4f} (gate {ST_GATE}; the reference 0.172, "
              f"published ~0.165), Cl amplitude {amp:.4f} (published "
              f"~0.33), {len(up) - 1} periods, div_linf "
              f"{float(d.div_linf):.3e}, plan {sim.kernels}")
        check(ST_GATE[0] <= st_num <= ST_GATE[1],
              f"cylinder_re100_2d: St {st_num} outside {ST_GATE}")


def _same(a, b):
    """Whether two States (or StepDiagnostics) hold the same members, bit
    for bit."""
    import dataclasses
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None):
            return False
        if x is not None and not torch.equal(x, y):
            return False
    return True


def _host_copy(st):
    from cfdnn_tpu_torch import State
    return State(**{k: (None if v is None else v.detach().cpu())
                    for k, v in vars(st).items()})


def _kernel_records(fn):
    """{kernel name: launches} of the device kernels torch.profiler
    (CUPTI) records over fn(), copies and fills left out, behind the
    short spin kernels of bench._window (the profiler lost the record of
    les_ibm256's first kernel, nu_sgs, in three windows of three without
    them); a window that lacks a record of a launch it must hold
    (`bench.window_complete`) is recorded again, up to
    bench.PROFILE_WINDOWS times."""
    from cfdnn_tpu_torch import bench
    missing = []
    for _ in range(bench.PROFILE_WINDOWS):
        # a one-cycle spin: the window's pad kernels without a wait
        prof, _, _, _, launched = bench._window(lambda n: fn(), 1, 1)
        events = bench._recorded(prof)[0]
        whole, got = bench.window_complete(events, launched)
        if whole:
            return {e.key: e.count for e in events if not bench.is_copy(e.key)}
        missing.append((got, launched))
    raise RuntimeError(f"torch.profiler lacked launches in every window "
                       f"((recorded, launched) {missing})")


# steps of the capture phase's runs: two chunks of GRAPH_CHUNK (16) steps,
# single-step graphs and the last step with the diagnostics
CAPTURE_STEPS = 37
# paths whose captured run and loop the capture phase also lists by
# torch.profiler's kernel records
CAPTURE_PROFILED = ("tgv", "les_channel_dynamic", "les_ibm256")


def phase_capture(device):
    """`Simulation.run` as it replays CUDA graphs against the plain loop of
    the same step (`Simulation._run_loop`) on each main path at its full
    width: CAPTURE_STEPS steps from one initial state, every State member
    and diagnostic bit for bit; then CAPTURE_STEPS more from each result,
    bit for bit again, the first captured State unchanged by the second
    run and the caller's initial state unchanged by either; the peak
    device memory of each (torch.cuda.max_memory_allocated, the captured
    run's first call, which captures, included); each graph's kernels,
    read off its nodes by name at capture, equal to its steps times the
    path's declared launches a step. On CAPTURE_PROFILED, the kernels
    torch.profiler records over a captured run equal to the loop's, kernel
    for kernel (a window that lacks a launch it must hold is recorded
    again)."""
    from cfdnn_tpu_torch import bench, solver
    # the card's gap between back-to-back kernels (bench.profiled's
    # correction), measured before any profiler window sees a graph: its
    # window of 256 launches must be recorded whole, and CUPTI dropped a
    # quarter of it once graph replays had been traced
    bench.launch_gap()
    rows = {}
    for path in _paths():
        if path.timed_only:
            continue
        name = path.name
        sim, st = build_case(path, path.n, device=device)
        fast = sim.cfg.benchmark or sim.cfg.perf_mode
        st_host = _host_copy(st)
        n = CAPTURE_STEPS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ref, dref = sim._run_loop(st, n, fast)
        torch.cuda.synchronize()
        loop_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got, dgot = sim.run(st, n)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        graph_peak = torch.cuda.max_memory_allocated() - base
        check(_same(ref, got) and _same(dref, dgot),
              f"{name}: captured run differs from the loop")
        got_host = _host_copy(got)
        ref2, dref2 = sim._run_loop(ref, n, fast)
        del ref
        got2, dgot2 = sim.run(got, n)
        check(_same(ref2, got2) and _same(dref2, dgot2),
              f"{name}: the second captured run differs from the loop")
        del ref2, got2
        check(_same(_host_copy(got), got_host),
              f"{name}: a later run changed the State an earlier one "
              "returned")
        check(_same(_host_copy(st), st_host),
              f"{name}: a run changed the caller's initial state")
        graphs = len(sim._graphs)
        rows[name] = dict(loop_mb=loop_peak / 2**20,
                          captured_mb=graph_peak / 2**20)
        print(f"[capture] {name} ({sim.kernels.predictor}, "
              f"{sim.kernels.closure}): {n} + {n} steps, captured run equal "
              f"to the loop bit for bit, State and diagnostics; {graphs} "
              f"graphs, first captured run {first:.2f} s; peak device "
              f"memory above the state loop {loop_peak / 2**20:.1f} MB, "
              f"captured {graph_peak / 2**20:.1f} MB")
        # what each graph holds: the port's kernels (read off its nodes by
        # name at capture) a step times its steps, as the path declares
        for (_, diags, steps), (_, held, nodes) in sorted(
                sim._graphs.items(), key=lambda kv: kv[0][1:]):
            want = {k: steps * c for k, c in path.launches.items() if c}
            print(f"[capture] {name} graph of {steps} steps "
                  f"({'with' if diags else 'without'} diagnostics): "
                  f"{nodes} kernel nodes, the port's {held}")
            check(held == want, f"{name}: a {steps}-step graph holds {held}, "
                  f"declared {want}")
        if name in CAPTURE_PROFILED:
            m = 2 * solver.GRAPH_CHUNK
            for turn in range(bench.PROFILE_WINDOWS):
                loop = _kernel_records(lambda: sim._run_loop(got, m, fast))
                graph = _kernel_records(lambda: sim.run(got, m))
                if loop == graph:
                    break
            print(f"[capture] {name} torch.profiler over {m} steps: loop "
                  f"{sum(loop.values())} kernel records of {len(loop)} "
                  f"kernels, captured {sum(graph.values())} of {len(graph)}")
            for k in sorted(set(loop) | set(graph)):
                if loop.get(k) != graph.get(k):
                    print(f"[capture]   {loop.get(k, 0):5d} loop "
                          f"{graph.get(k, 0):5d} captured  {k[:100]}")
            check(loop == graph, f"{name}: the captured run's kernel records "
                  "differ from the loop's")
        del sim, st, got, dgot
    print(json.dumps({"capture_peak_mb": rows}))


# The JAX package's CPU values of the apps phase's float64 runs, at the
# same arguments (python -m cfdnn_tpu.apps.duct / .taylor_green_3d with
# JAX on the CPU in float64; PERF.md): the duct's series-solution
# error after its steady solve (21100 steps) and the 32^3 Taylor-Green's
# kinetic energy and enstrophy after 50 steps
DUCT_ARGS = ["--Nx", "64", "--Ny", "48", "--Nz", "48", "--nu", "0.05",
             "--dt", "2e-3", "--adaptive_dt", "false", "--max_steps",
             "40000", "--diag_interval", "100"]
DUCT_STEPS_REF = 21100
DUCT_REL_ERR_REF = 0.0016456839929060443
TGV32_ARGS = ["--Nx", "32", "--Ny", "32", "--Nz", "32", "--dtype", "float64",
              "--max_steps", "50"]
TGV32_KE_REF = 0.11841308381136248
TGV32_ENSTROPHY_REF = 1.411811705250982
# the verify recipe's Poiseuille (nu 0.05, dp/dx -1, dt 5e-3, rest start)
# at 32x64x32; z spans 2 pi as x does (on z's default unit span the
# explicit diffusion limit would be 4.8e-3 < dt)
CHANNEL_ARGS = ["--Nx", "32", "--Ny", "64", "--Nz", "32", "--z_max",
                repr(2 * math.pi), "--nu", "0.05", "--dp_dx", "-1", "--dt",
                "5e-3", "--adaptive_dt", "false", "--max_steps", "30000",
                "--diag_interval", "100"]
APP_COMMON = ["--num_snapshots", "0", "--write_fields", "false"]
# each app's kernel launches a step: the Taylor-Green's three RK3 stages on
# the periodic predictor, the 3-D channel's and the duct's Euler step on the
# channel and the general predictor
APP_LAUNCHES = {
    "taylor_green_3d": dict(predictor_periodic=3, divergence=3, correct=3),
    "channel": dict(predictor_channel=1, divergence=1, correct=1),
    "duct": dict(predictor_general=1, divergence=1, correct=1),
}


def phase_apps(device):
    """The apps as a user starts them (their `main`, or run_case with a
    callback), on the card: the 128^3 Re 1600 Taylor-Green in float32 for
    300 steps, its kinetic energy non-increasing step to step, div_linf <=
    1e-3, its QOI lines printed; the channel's Poiseuille (CHANNEL_ARGS) to
    steady state, rel L2 against the exact profile <= 4e-4; the duct
    (DUCT_ARGS) to steady state, its series-solution error equal to the
    JAX package's CPU value to 1e-6 relative at the same step; the 32^3
    float64 Taylor-Green of 50 steps, its kinetic energy and enstrophy
    equal to the JAX package's CPU values to 1e-10 relative. Each app's
    kernel launches (counted from 0 before it) are its steps' and its
    graphs' warm-up steps' (one a graph) times APP_LAUNCHES."""
    from cfdnn_tpu_torch.apps import channel, duct, runner, taylor_green_3d
    from cfdnn_tpu_torch.fields import init_taylor_green
    from cfdnn_tpu_torch.ops import kernels as K
    check(device.type == "cuda", "the apps phase runs on the card")

    def launches(app, sim, st):
        counts = {k: c for k, c in K.launch_counts().items() if c}
        steps, warm = int(st.step), len(sim._graphs)
        want = {k: (steps + warm) * c for k, c in APP_LAUNCHES[app].items()}
        print(f"[apps] {app} launches {counts} in {steps} steps and {warm} "
              f"warm-up steps: {APP_LAUNCHES[app]} a step")
        check(counts == want, f"{app}: launches {counts}, expected {want}")
        K.reset_launch_counts()

    kes = []
    K.reset_launch_counts()
    with timed("apps taylor_green_3d 128^3"):
        sim, st, d = runner.run_case(
            "taylor_green_3d", taylor_green_3d.default_config(),
            ["--Nx", "128", "--Ny", "128", "--Nz", "128", "--Re", "1600",
             "--max_steps", "300", "--output_freq", "100", *APP_COMMON],
            ic=init_taylor_green, validate=taylor_green_3d.validate,
            callback=lambda it, s, dd: kes.append(float(dd.ke)))
    check(sim.device.type == "cuda" and sim.cfg.dtype == "float32",
          f"tgv128 app on {sim.device}, {sim.cfg.dtype}")
    rises = [i for i in range(1, len(kes)) if kes[i] > kes[i - 1]]
    div = float(d.div_linf)
    print(f"[apps] taylor_green_3d 128^3 Re 1600 float32: {len(kes)} steps, "
          f"KE {kes[0]:.7e} -> {kes[-1]:.7e}, steps where KE rose "
          f"{len(rises)}, div_linf {div:.3e}, t {float(st.t):.6f}")
    check(len(kes) == 300 and not rises, f"tgv128 app: KE rose at {rises}")
    check(div <= 1e-3, f"tgv128 app: div_linf {div}")
    launches("taylor_green_3d", sim, st)
    with timed("apps channel"):
        sim, st, d = channel.main(CHANNEL_ARGS + APP_COMMON)
    launches("channel", sim, st)
    rel = channel.validate(sim, st, d)["poiseuille_rel_l2"]
    print(f"[apps] channel 32x64x32 float64: {int(st.step)} steps, "
          f"Poiseuille rel L2 {rel:.6e} (limit 4e-4)")
    check(rel <= 4e-4, f"channel app: rel L2 {rel}")
    with timed("apps duct"):
        sim, st, d = duct.main(DUCT_ARGS + APP_COMMON)
    launches("duct", sim, st)
    err = duct.validate(sim, st, d)["duct_bulk_rel_err"]
    steps = int(st.step)
    print(f"[apps] duct 64x48x48 float64: {steps} steps (JAX CPU "
          f"{DUCT_STEPS_REF}), series error {err!r} (JAX CPU "
          f"{DUCT_REL_ERR_REF!r}, d {abs(err / DUCT_REL_ERR_REF - 1):.3e})")
    check(steps == DUCT_STEPS_REF
          and abs(err - DUCT_REL_ERR_REF) <= 1e-6 * DUCT_REL_ERR_REF,
          f"duct app: {steps} steps, error {err}")
    with timed("apps taylor_green_3d 32^3"):
        sim, st, d = taylor_green_3d.main(TGV32_ARGS + APP_COMMON)
    launches("taylor_green_3d", sim, st)
    ke, ens = float(d.ke), taylor_green_3d.enstrophy(sim, st)
    print(f"[apps] taylor_green_3d 32^3 float64 50 steps: KE {ke!r} (JAX "
          f"CPU {TGV32_KE_REF!r}), enstrophy {ens!r} (JAX CPU "
          f"{TGV32_ENSTROPHY_REF!r})")
    check(abs(ke - TGV32_KE_REF) <= 1e-10 * TGV32_KE_REF
          and abs(ens - TGV32_ENSTROPHY_REF) <= 1e-10 * TGV32_ENSTROPHY_REF,
          f"tgv32 app: KE {ke}, enstrophy {ens}")


def _event_ms(fn, reps=50):
    """Milliseconds per call by CUDA events around `reps` calls: the time
    a caller waits, host-side wrapper work included where it is longer
    than the device's."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps=20):
    """Device milliseconds per call: the kernels' own time, from
    torch.profiler (bench.profiled), summed over every kernel the call
    launches as its mean time a launch times its launches a call (its
    records over reps, rounded): the profiler can drop a record, which
    read a 4 ms kernel 20% short over 5 reps."""
    from cfdnn_tpu_torch.bench import profiled
    fn()
    torch.cuda.synchronize()
    events, reps, _ = profiled(lambda n: [fn() for _ in range(n)], reps)
    return sum(e.self_device_time_total / e.count * round(e.count / reps)
               for e in events) / 1e3


def _port_kernel_ms(fn, reps=20):
    """Device milliseconds per call of the port's own kernels among the
    call's launches (torch.profiler, as `_device_ms`): a wrapper's kernel
    alone, without the torch kernels it launches around it (the xpad
    wrapper's pads)."""
    from cfdnn_tpu_torch.bench import profiled
    from cfdnn_tpu_torch.ops import kernels as K
    fn()
    torch.cuda.synchronize()
    events, reps, _ = profiled(lambda n: [fn() for _ in range(n)], reps)
    return sum(e.self_device_time_total / e.count * round(e.count / reps)
               for e in events if K.device_launches([(e.key, 1)])) / 1e3


def _bound(case, outputs):
    """(ms, "bytes" | "operations"): the least time the card could take
    for the call, the larger of its bytes (each input read once, each
    output written once) over the HBM rate and its operations (the case's
    own `ops`, else OPS_PER_CELL of its label, else of the kernel, times
    the cells of its first output) over the float32 peak."""
    outs = _as_tuple(outputs)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*case.inputs, *outs))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops = (case.ops if case.ops is not None
           else OPS_PER_CELL.get(case.label, OPS_PER_CELL[case.name]))
    by_ops = ops * outs[0].numel() / F32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


# marginal-step timing windows: the reference's bench.py rows over 1000
# steps, its LES rows (and the port's RANS and Re 1600 rows) over 400, its
# LES + IBM row over 150 (bench.py:110), its 512^3 rows over 100
# (bench.py:185-186)
TIMED_STEPS = {"tgv": 1000, "channel": 1000, "les_ibm256": 150,
               "tgv512": 100, "channel512": 100, "tgv512_pfht": 100,
               "channel512_pfht": 100, "les_tgv640": 100,
               "tgv_re1600_o4_512": 100, "channel512_o4": 100,
               # ~4100 launches a step (the plain Thomas sweeps; its loop
               # 65 ms/step on an H100, PERF.md)
               "rans_channel_imex": 50,
               # the loops of these two take 5-13 ms a step: the depth
               # the script's time limit leaves them (bench.py: 400)
               "les_cylinder3900": 150, "rans_channel_earsm_wj": 150}
# paths whose step launches thousands of kernels (the plain Thomas sweeps):
# their device ms/step is one step captured alone in a CUDA graph and
# replayed under the profiler (`_chain_ms`), not a window of `run` (CUPTI
# left one kernel record out of each replay of its 4120-node graphs,
# three windows of three, so `bench.window_complete` refused every one),
# and their loop is timed but not profiled (its launches outrun the
# card's queue, so no window of it is gated)
STEP_CHAIN = ("rans_channel_imex",)
# best-of repetitions of the marginal (bench.time_steps' 3), fewer where a
# step takes tens of milliseconds
TIMED_REPS = {"les_tgv640": 1, "tgv_re1600_o4_512": 1, "channel512_o4": 1,
              "rans_channel_imex": 1}
# paths also timed a step at a time, as advance_unsteady runs with a
# callback (the apps' unsteady loop): `step` replaying one-step graphs
# against the plain loop stepped one step a call
STEPWISE = ("tgv", "les_channel", "tgv_re1600", "les_tgv640")


def _time_path(path, sim, st, rows, loop=True):
    """ms/step, Mcells/s (and the div) of a path's `run` (its CUDA graphs)
    into `rows`, and its torch.profiler breakdown printed; with `loop`, the
    same of the plain loop of the step (`Simulation._run_loop`) beside it
    (rows' `<path>_loop_ms_per_step`, `<path>_loop_device_ms_per_step`);
    returns (ms/step, device ms/step, div_linf after the first timed run)
    of `run`."""
    from cfdnn_tpu_torch import bench
    name = path.name
    steps = TIMED_STEPS.get(name.replace("_fused", ""), 400)
    reps = TIMED_REPS.get(name, 3)
    s, d = bench.time_steps(sim, st, steps=steps, reps=reps)
    rows[f"{name}_ms_per_step"] = s * 1e3
    rows[f"{name}_mcells_per_s"] = _cells(sim) / s / 1e6
    if sim.cfg.bc_y.value == "wall":
        rows[f"{name}_div_linf_f32"] = float(d.div_linf)
    if name in STEP_CHAIN:
        fast = sim.cfg.benchmark or sim.cfg.perf_mode
        busy, launches, _ = _chain_ms(
            lambda: sim._step_impl(st, with_diags=not fast), reps=5)
        print(f"[profile] {name}: device {busy:.4f} ms/step of "
              f"{s * 1e3:.4f} ms/step (idle share "
              f"{1 - busy / (s * 1e3):.3f}; one step captured alone, "
              f"{launches:g} kernels)")
    else:
        prof = bench.profile_steps(sim, st)
        busy = prof["device_ms_per_step"]
        print(f"[profile] {name}: device {busy:.4f} ms/step of "
              f"{s * 1e3:.4f} ms/step (idle share "
              f"{1 - busy / (s * 1e3):.3f}; device span "
              f"{prof['span_ms_per_step']:.4f} ms/step over "
              f"{prof['steps']} steps)")
        for kname, ms, count in prof["kernels"][:12]:
            print(f"[profile]   {ms:9.5f} ms/step  x{count:g}  "
                  f"{kname[:110]}")
    check(busy > 0, f"{name}: the profiler recorded no device time")
    rows[f"{name}_device_ms_per_step"] = busy
    if loop:
        fast = sim.cfg.benchmark or sim.cfg.perf_mode

        def run_loop(state, n):
            return sim._run_loop(state, n, fast)

        s_loop, _ = bench.time_steps(sim, st, steps=steps, reps=reps,
                                     run=run_loop)
        rows[f"{name}_loop_ms_per_step"] = s_loop * 1e3
        if name in STEP_CHAIN:
            print(f"[profile] {name} loop: {s_loop * 1e3:.4f} ms/step (not "
                  f"profiled); captured {s * 1e3:.4f} ms/step, "
                  f"{s_loop / s:.3f}x faster")
        else:
            busy_loop = bench.profile_steps(sim, st, run=run_loop)[
                "device_ms_per_step"]
            rows[f"{name}_loop_device_ms_per_step"] = busy_loop
            print(f"[profile] {name} loop: device {busy_loop:.4f} ms/step "
                  f"of {s_loop * 1e3:.4f} ms/step (idle share "
                  f"{1 - busy_loop / (s_loop * 1e3):.3f}); captured "
                  f"{s * 1e3:.4f} ms/step, {s_loop / s:.3f}x faster")
    if loop and name in STEPWISE:
        _time_stepwise(name, sim, st, steps, reps, rows)
    if name in BREAKDOWNS:
        BREAKDOWNS[name](name, sim, st, busy, rows)
    return s * 1e3, busy, float(d.div_linf)


def _chain_ms(fn, reps=20):
    """(device ms a call, kernels a call, {"gemm" | "fft" | "other": device
    ms a call}) of a plain-torch chain: fn() captured in a CUDA graph (after
    one uncaptured call) and its replays profiled (bench.profiled), so the
    chain's kernels run back to back without its host time. Not for a
    chain that launches one of the port's kernels (a replay adds no
    launches to its count)."""
    from cfdnn_tpu_torch.bench import is_copy, profiled
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.no_grad():
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    events, reps, _ = profiled(lambda n: [graph.replay() for _ in range(n)],
                               reps)
    parts = {"gemm": 0.0, "fft": 0.0, "other": 0.0}
    for e in events:
        key = e.key.lower()
        part = ("gemm" if "gemm" in key or "cutlass" in key
                else "fft" if "fft" in key else "other")
        parts[part] += e.self_device_time_total / reps / 1e3
    n = sum(e.count for e in events if not is_copy(e.key)) / reps
    del graph
    return sum(parts.values()), n, parts


def _print_breakdown(name, busy, rows, parts):
    """Each part's device ms a call, calls a step, ms/step and share of the
    step's device ms/step (`busy`), into rows[<name>_breakdown]."""
    table = {}
    for part, (ms, calls, launches) in parts.items():
        table[part] = dict(ms_per_call=ms, calls_per_step=calls,
                           ms_per_step=ms * calls,
                           share=ms * calls / busy, launches_per_call=launches)
        print(f"[profile] {name} part {part}: {ms:.5f} ms a call x {calls} a "
              f"step = {ms * calls:.5f} ms/step, share "
              f"{ms * calls / busy:.3f} of {busy:.4f} device ms/step "
              f"({launches:g} launches a call)")
    rest = busy - sum(v["ms_per_step"] for v in table.values())
    print(f"[profile] {name} part rest (BCs, blends, dt, diagnostics, state "
          f"copies): {rest:.5f} ms/step, share {rest / busy:.3f}")
    rows[f"{name}_breakdown"] = table


def _breakdown_les_cylinder(name, sim, st, busy, rows):
    """les_cylinder3900's device ms/step by part, each timed alone on the
    path's state: predictor_general on the padded fields (the profiler's
    device ms) and the pads (`_xpad_fields`), three a step (RK3); WALE's
    plain nu_t, one; the FDM solve, three (its eigenbasis GEMMs on x,
    cuFFT on y and z); IBM forcing, six (after each predictor and each
    correction); the convective outlet and the outlet's flux anchor,
    three each."""
    from cfdnn_tpu_torch.ops import kernels as K
    comps = tuple(st.velocity)
    nu_t = sim.turb.nu_t(st, sim)
    dt = sim._dt
    xg, gs = sim._gen_geom, sim._gen_arrays
    padded = K._xpad_fields(*comps, nu_t, sim.geom)
    kg = dict(geom=xg, nu=float(sim.cfg.nu), fx=sim._fx,
              scheme=sim.cfg.convective_scheme)
    kern = _device_ms(lambda: K.predictor_general(*padded[:3], dt, gs,
                                                  nu_t=padded[3], **kg))
    rhs = torch.randn(nu_t.shape, dtype=nu_t.dtype, device=nu_t.device)
    solve_ms, solve_n, solve_parts = _chain_ms(lambda: sim.poisson.solve(rhs))
    pads = _chain_ms(lambda: K._xpad_fields(*comps, nu_t, sim.geom))
    wale = _chain_ms(lambda: sim.turb.nu_t(st, sim))
    ibm = _chain_ms(lambda: sim.ibm.apply(comps, dt, accumulate=True))
    outlet = _chain_ms(lambda: sim._convective_outlet(comps, comps, dt))
    anchor = _chain_ms(lambda: sim._anchor_outlet_flux(comps))
    parts = {
        "predictor_general": (kern, 3, 1),
        "pads": (pads[0], 3, pads[1]),
        "wale_plain": (wale[0], 1, wale[1]),
        "fdm_x_gemms": (solve_parts["gemm"], 3, solve_n),
        "fdm_cufft_yz": (solve_parts["fft"], 3, 0),
        "fdm_other": (solve_parts["other"], 3, 0),
        "ibm": (ibm[0], 6, ibm[1]),
        "convective_outlet": (outlet[0], 3, outlet[1]),
        "outlet_flux_anchor": (anchor[0], 3, anchor[1]),
    }
    _print_breakdown(name, busy, rows, parts)


def _breakdown_rans_imex(name, sim, st, busy, rows):
    """rans_channel_imex's device ms/step by part: the implicit
    y-diffusion of the velocity (three Thomas solves, `forcing.
    implicit_y_diffusion`) and of k and omega (two,
    `implicit_scalar_y_diffusion`), one each a step, each timed alone on
    the path's state."""
    from cfdnn_tpu_torch import forcing
    comps = tuple(st.velocity)
    nu_eff = sim.cfg.nu + st.nu_t
    dt = sim._dt
    vel = _chain_ms(lambda: forcing.implicit_y_diffusion(comps, nu_eff, dt,
                                                         sim.geom))
    scal = _chain_ms(lambda: forcing.implicit_scalar_y_diffusion(
        st.k, nu_eff, dt, sim.geom, 0.0))
    parts = {"thomas_velocity": (vel[0], 1, vel[1]),
             "thomas_k_omega": (scal[0], 2, scal[1])}
    _print_breakdown(name, busy, rows, parts)


BREAKDOWNS = {"les_cylinder3900": _breakdown_les_cylinder,
              "rans_channel_imex": _breakdown_rans_imex}


def _time_stepwise(name, sim, st, steps, reps, rows):
    """Marginal ms/step of advance_unsteady with a callback (a `step` a
    step: one-step graphs, the state cloned out each step) beside the
    plain loop stepped one step a call, every step with its diagnostics
    in both (rows' `<path>_stepwise_ms_per_step`,
    `<path>_stepwise_loop_ms_per_step`)."""
    from cfdnn_tpu_torch import bench
    fast = sim.cfg.benchmark or sim.cfg.perf_mode

    def graphs(state, n):
        return sim.advance_unsteady(state, n, callback=lambda *a: None)

    def loop(state, n):
        for _ in range(n):
            state, d = sim._run_loop(state, 1, fast)
        return state, d

    ms = {}
    for tag, run in (("graphs", graphs), ("loop", loop)):
        ms[tag] = bench.time_steps(sim, st, steps=steps, reps=reps,
                                   run=run)[0] * 1e3
    rows[f"{name}_stepwise_ms_per_step"] = ms["graphs"]
    rows[f"{name}_stepwise_loop_ms_per_step"] = ms["loop"]
    print(f"[profile] {name} a step a call (advance_unsteady with a "
          f"callback): graphs {ms['graphs']:.4f} ms/step, loop "
          f"{ms['loop']:.4f} ms/step, {ms['loop'] / ms['graphs']:.3f}x")


def _pair_ms(case, reps, dreps):
    """(ms a call by CUDA events, device ms) of a div kernel's unfused
    pair, (None, None) for any other case."""
    if case.pair is None:
        return None, None
    return _event_ms(case.pair, reps), _device_ms(case.pair, dreps)


def _pair_text(t):
    return ("" if t[7] is None else
            f"; the unfused pair (predictor + divergence) per call "
            f"{t[7]:.4f} ms, device {t[8]:.4f} ms")


def phase_timing(device, errs):
    """Each unfused main path's marginal ms/step with its profile (the
    fused paths are timed by phase_ab), then each kernel against its twin
    at the main-path shapes, the four slab kernels on a walked tile also at
    512^3; those and the xz kernels (on the les_tgv640 cube) are checked there
    too (their errors into `errs`)."""
    rows, divs = {}, {}
    for path in _paths():
        if not path.name.endswith("_fused"):
            with timed(f"timing {path.name}"):
                divs[path.name] = _time_path(
                    path, *build_case(path, path.n, device=device), rows)[2]
    for name in ("tgv512", "channel512"):
        steps = TIMED_STEPS[name]
        print(f"[timing] {name}_pfht div_linf after {steps} steps "
              f"{divs[name + '_pfht']:.3e} (cuFFT {name}: "
              f"{divs[name]:.3e})")
    # the momentum ladder of scripts/measure_upwind.py:58-68 on the 128^3
    # channel: each scheme's marginal step and its device time
    ladder = (("skew", "channel_skew"), ("central", "channel"),
              ("upwind", "channel_upwind"), ("upwind2", "channel_upwind2"))
    print(f"[ladder] {card_line()}: the 128^3 channel (laminar, float32, "
          "benchmark mode) by momentum scheme: " + "; ".join(
              f"{scheme} {rows[name + '_ms_per_step']:.4f} ms/step, device "
              f"{rows[name + '_device_ms_per_step']:.4f} ms/step"
              for scheme, name in ladder))
    rows["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rows))
    times = {}
    with torch.no_grad():
        for case in (_cases(128, torch.float32, device, seed=2)
                     + _div_cases(128, torch.float32, device, seed=2)
                     + _fht_cases(torch.float32, device, seed=2)
                     + _o4_cases(torch.float32, device, seed=2)):
            if case.label in times:   # timed on the first (main-path) grid
                continue
            # the 512^3 Hartley calls take milliseconds: fewer reps
            reps, dreps = (10, 5) if case.library else (50, 20)
            lib = _event_ms(case.library, reps) if case.library else None
            t = times[case.label] = (
                case.name, _event_ms(case.kern, reps),
                _event_ms(case.twin, reps), _device_ms(case.kern, dreps),
                _device_ms(case.twin, dreps), _bound(case, case.twin()), lib,
                *_pair_ms(case, reps, dreps))
            print(f"[timing] {case.label} float32: per call kernel "
                  f"{t[1]:.4f} ms, twin {t[2]:.4f} ms; device kernel "
                  f"{t[3]:.4f} ms, twin {t[4]:.4f} ms; bound {t[5][0]:.4f} "
                  f"ms ({t[5][1]})"
                  + ("" if lib is None else
                     f"; torch.fft.{case.library.__name__} {lib:.4f} ms")
                  + _pair_text(t))
        # the upwind variants' float32 calls (`_upwind_cases`), each beside
        # its twin (5-30 ms a call at 128^3, ~0.1 s on the 640 and 512
        # planes: over fewer reps), the xz ones also beside the slab kernel
        # on the same inputs
        for case in _upwind_cases(torch.float32, device, seed=2):
            big = " plane" in case.label
            ref = case.twin()
            t = times[case.label] = (
                case.name, _event_ms(case.kern, 20 if big else 50),
                _event_ms(case.twin, 3 if big else 10),
                _device_ms(case.kern, 5 if big else 20),
                _device_ms(case.twin, 2 if big else 5), _bound(case, ref),
                None,
                *((_event_ms(case.slab, 20), _device_ms(case.slab, 5))
                  if case.slab else (None, None)))
            print(f"[timing] {case.label} float32: per call kernel "
                  f"{t[1]:.4f} ms, twin {t[2]:.4f} ms; device kernel "
                  f"{t[3]:.4f} ms, twin {t[4]:.4f} ms; bound {t[5][0]:.4f} "
                  f"ms ({t[5][1]})"
                  + ("" if t[7] is None else
                     f"; the slab kernel per call {t[7]:.4f} ms, device "
                     f"{t[8]:.4f} ms")
                  # through xpad also the kernel alone, without the pads
                  + (f"; the kernel alone device "
                     f"{_port_kernel_ms(case.kern):.4f} ms"
                     if " xpad " in case.label else ""))
            del case, ref
        # predictor_general through xpad on the LES cylinder's inflow x
        # (its own call: 256x192x32 padded to 258 planes, skew, WALE's
        # nu_t), held to its twin and timed beside it; the pads alone
        # (`_xpad_fields`, two torch.cat a field) beside it
        from cfdnn_tpu_torch import bench
        from cfdnn_tpu_torch.mesh import Mesh
        from cfdnn_tpu_torch.ops import kernels as K
        from cfdnn_tpu_torch.ops.grid import Geometry
        cfg = bench.les_cylinder_config().finalize()
        geom = Geometry.make(Mesh.from_config(cfg), cfg, device=device)
        for case in _xpad_cases(torch.float32, device, seed=2,
                                grids=_XPAD_GRIDS[:1]):
            if case.label != XPAD_MAIN:
                continue
            ref = _hold(case, torch.float32, errs)
            t = times[case.label] = (
                case.name, _event_ms(case.kern), _event_ms(case.twin, 20),
                _device_ms(case.kern), _device_ms(case.twin, 10),
                _bound(case, ref), None, None, None)
            u, v, w, nu_t = (case.inputs[i] for i in (0, 1, 2, -1))
            pads = _chain_ms(lambda: K._xpad_fields(u, v, w, nu_t, geom))
            times["xpad pads"] = pads
            print(f"[timing] {case.label} float32: per call kernel "
                  f"{t[1]:.4f} ms, twin {t[2]:.4f} ms; device kernel "
                  f"{t[3]:.4f} ms, twin {t[4]:.4f} ms; bound {t[5][0]:.4f} "
                  f"ms ({t[5][1]}); the pads alone (_xpad_fields) device "
                  f"{pads[0]:.4f} ms, {pads[1]:g} launches")
            del case, ref
        # the six slab kernels that walk an (x, z) tile at 512^3
        # (channel512's and tgv512's predictor, tgv512's and channel512's
        # correction and divergence, the two div kernels beside their
        # unfused pairs), each checked against its twin and timed beside
        # it (the twin over fewer reps: tens of milliseconds a call there)
        for case in _tile_cases_512(device, seed=2):
            ref = _hold(case, torch.float32, errs)
            t = times[case.label] = (
                case.name, _event_ms(case.kern, 20), _event_ms(case.twin, 3),
                _device_ms(case.kern, 5), _device_ms(case.twin, 2),
                _bound(case, ref), None, *_pair_ms(case, 20, 5))
            print(f"[timing] {case.label} float32: per call kernel "
                  f"{t[1]:.4f} ms, twin {t[2]:.4f} ms; device kernel "
                  f"{t[3]:.4f} ms, twin {t[4]:.4f} ms; bound {t[5][0]:.4f} "
                  f"ms ({t[5][1]})" + _pair_text(t))
            del case, ref
        # the xz kernels on the les_tgv640 cube, each checked against its
        # twin and the slab kernel of its function, and timed beside that
        # slab kernel on the same inputs (the twins, tens to hundreds of
        # milliseconds a call there, over fewer reps)
        for case in _xz_cases(torch.float32, device, seed=2, nx=640,
                              small=False):
            errs.setdefault("vs slab", {}).pop(case.label, None)
            ref = _hold(case, torch.float32, errs)
            print(f"[kernels] {case.label} float32 640^3 vs the slab "
                  f"kernel on the same inputs: max|d| / max|slab| = "
                  f"{errs['vs slab'][case.label]:.3e}")
            if any(t[0] == case.name for t in times.values()):
                continue   # timed on its first (main-path) case
            t = times[case.label] = (
                case.name, _event_ms(case.kern, 20), _event_ms(case.twin, 3),
                _device_ms(case.kern, 5), _device_ms(case.twin, 2),
                _bound(case, ref), None, _event_ms(case.slab, 20),
                _device_ms(case.slab, 5))
            print(f"[timing] {case.label} float32 640^3: per call kernel "
                  f"{t[1]:.4f} ms, twin {t[2]:.4f} ms, slab kernel "
                  f"{t[7]:.4f} ms; device kernel {t[3]:.4f} ms, twin "
                  f"{t[4]:.4f} ms, slab kernel {t[8]:.4f} ms; bound "
                  f"{t[5][0]:.4f} ms ({t[5][1]})")
        # the O4 xz variants at 512^3 (tgv_re1600_o4_512's and
        # channel512_o4's inputs), each checked against its twin and the
        # O4 slab kernel of its function and timed beside that slab kernel
        # on the same inputs: the A/B of the two O4 tilings (recorded; the
        # plan routes as the reference does)
        for case in _xz_o4_cases(torch.float32, device, seed=2, nx=512,
                                 small=False):
            errs.setdefault("vs slab", {}).pop(case.label, None)
            ref = _hold(case, torch.float32, errs)
            t = times[case.label] = (
                case.name, _event_ms(case.kern, 20), _event_ms(case.twin, 3),
                _device_ms(case.kern, 5), _device_ms(case.twin, 2),
                _bound(case, ref), None, _event_ms(case.slab, 20),
                _device_ms(case.slab, 5))
            print(f"[timing] {case.label} float32 512^3: per call kernel "
                  f"{t[1]:.4f} ms, twin {t[2]:.4f} ms, O4 slab kernel "
                  f"{t[7]:.4f} ms; device kernel {t[3]:.4f} ms, twin "
                  f"{t[4]:.4f} ms, O4 slab kernel {t[8]:.4f} ms; bound "
                  f"{t[5][0]:.4f} ms ({t[5][1]}); max|d| / max|slab| = "
                  f"{errs['vs slab'][case.label]:.3e}")
            del case, ref
    return rows, times


def phase_solve(device):
    """The 512^3 Poisson solve alone, "fft" (cuFFT) against "pallas_fft"
    (the Hartley kernels), with the tgv512 and channel512 solvers: ms per
    call by CUDA events on one random rhs, and each solve's relative
    residual (solve_with_stats)."""
    from cfdnn_tpu_torch import bench
    from cfdnn_tpu_torch.mesh import Mesh
    from cfdnn_tpu_torch.poisson.fdm import FDMPoissonSolver
    gen = torch.Generator(device=device).manual_seed(3)
    rhs = torch.randn((512, 512, 512), generator=gen, dtype=torch.float32,
                      device=device)
    rows = {}
    with torch.no_grad():
        for tag, config in (("tgv512", bench.tgv_config),
                            ("channel512", bench.channel_config)):
            for transform in ("fft", "pallas_fft"):
                cfg = config(512, poisson_transform=transform).finalize()
                s = FDMPoissonSolver(Mesh.from_config(cfg), cfg,
                                     device=device)
                ms = _event_ms(lambda: s.solve(rhs), reps=10)
                res = s.solve_with_stats(rhs)[1].rel_residual
                check(math.isfinite(res) and res < 1e-3,
                      f"{tag} {transform}: residual {res}")
                rows[f"{tag}_solve_{transform}_ms"] = ms
                rows[f"{tag}_solve_{transform}_rel_residual"] = res
                print(f"[solve] {tag} {s.name} float32: {ms:.4f} ms per "
                      f"call, rel residual {res:.3e}")
    print(json.dumps(rows))
    return rows


def phase_ab(device):
    """The fused divergence against the unfused step, in one call, in the
    order off, on, on, off, on tgv, channel and les_channel: ms/step and
    device ms/step of each (data for PERF.md, not a gate)."""
    paths = {p.name: p for p in _paths()}
    rows = {}
    for base in ("tgv", "channel", "les_channel"):
        for turn, fused in enumerate((False, True, True, False)):
            path = paths[base + "_fused" if fused else base]
            ms, busy, _ = _time_path(
                path, *build_case(path, path.n, device=device), {},
                loop=False)
            print(f"[ab] {base} turn {turn + 1} "
                  f"{'fused' if fused else 'unfused'}: {ms:.4f} ms/step, "
                  f"device {busy:.4f} ms/step")
            rows.setdefault(f"{base}_{'fused' if fused else 'unfused'}",
                            []).append([ms, busy])
    print(json.dumps({"ab": rows}))


def kernel_entries(errs, launches, per_step, times):
    """The `kernels` JSON line's entries, one for each kernel of
    ops.kernels: ms and plain_ms (and the bound) of its first, main-path
    case, every case of the kernel under "variants", and its launches per
    step on each main path that ran it."""
    from cfdnn_tpu_torch.ops import kernels as K
    entries = []
    for k in K.KERNELS:
        name = k.__name__
        variants = {}
        for label, t in times.items():
            if label == "xpad pads" or t[0] != name:
                continue
            # an xz kernel's slab kernel, a div kernel's unfused pair
            beside = "pair" if name in DIV_KERNELS else "slab"
            row = dict(zip(("ms", "plain_ms", "device_ms", "plain_device_ms",
                            "bound_ms", "bound_by", "library_ms",
                            f"{beside}_ms", f"{beside}_device_ms"),
                           t[1:5] + t[5] + t[6:]))
            if row[f"{beside}_ms"] is None:
                # only the xz and div kernels have a kernel beside them
                del row[f"{beside}_ms"], row[f"{beside}_device_ms"]
            variants[label] = row
        main_case = next(iter(variants.values()))
        entries.append({
            "name": name, "route": "cuda",
            "source": ("cfdnn_tpu_torch/csrc/"
                       + KERNEL_SOURCE.get(name, name + ".cu")),
            "replaces": KERNEL_REPLACES[name],
            **({"source_o4": "cfdnn_tpu_torch/csrc/" + KERNEL_SOURCE_O4[name]}
               if name in KERNEL_SOURCE_O4 else {}),
            "launches": launches[name],
            "launches_per_step": per_step[name],
            "max_abs_err": errs[name][1],
            "max_abs_err_f64": errs[name][0],
            # the O4 variant's cases (`_o4_cases`), where it has one
            **({"max_abs_err_o4": errs["o4"][name][1],
                "max_abs_err_o4_f64": errs["o4"][name][0]}
               if name in errs.get("o4", {}) else {}),
            # the upwind and upwind2 variants' cases (`_upwind_cases`)
            **({"max_abs_err_upwind": errs["upwind"][name][1],
                "max_abs_err_upwind_f64": errs["upwind"][name][0]}
               if name in errs.get("upwind", {}) else {}),
            # no single PyTorch call computes any of these stencils
            # (library_ms None); the Hartley kernels' yardstick is torch.fft
            # along the same axis of the same tensor: fht_pass's one rfft
            # (forward) or irfft (inverse), fht_modal's rfft + irfft
            **main_case, "variants": variants,
        })
    return entries


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card only", file=sys.stderr)
        return 1
    # the port itself, before anything is printed: a copy of this script
    # alone fails here
    import cfdnn_tpu_torch  # noqa: F401
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    with timed("build"):
        phase_build()
    with timed("kernels"):
        errs = phase_kernels(device)
    with timed("capture"):
        phase_capture(device)
    with timed("main paths"):
        launches, divs, per_step = phase_main_path(device)
    with timed("trajectories"):
        phase_trajectories(device)
    with timed("xz trajectories"):
        phase_xz_trajectories(device)
    with timed("a8"):
        phase_a8(device)
    with timed("apps"):
        phase_apps(device)
    with timed("timing"):
        rows, times = phase_timing(device, errs)
    with timed("solve"):
        phase_solve(device)
    with timed("ab"):
        phase_ab(device)
    entries = kernel_entries(errs, launches, per_step, times)
    for name, (div, steps) in divs.items():
        print(f"[main] {name}_div_linf ({steps} steps) = {div:.3e}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
