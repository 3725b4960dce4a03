#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

1. Prints the card (nvidia-smi name, power limit), torch and CUDA
   versions; fails without a CUDA device.
2. Builds every CUDA kernel from the checkout's sources, all nvcc runs
   started together (sm_90a): K1 + K2 per tree, and the four
   tree-independent marching-cubes kernels K3 (compact_active), K4
   (compact_emit), K7s (emit_soup), K7w (emit_welded); prints ptxas'
   registers and spills; KP (point_eval) per tree, 3D and 2D, and K2-2D
   (grid_eval_2d) per 2D tree, each a library of its own. Holds KP against
   its plain torch version at seeded points on every tree, on one 2D
   recipe per 2D node type, on the three 2D scenes the example programs
   render and on the special evaluators' trees, and holds it equal to K2
   bit for bit at a grid's positions; holds K2-2D against its plain
   version on the same 2D trees (the scenes at the examples' sizes: plant
   pot 1080 x 1080, mandala 768 x 768, thread profile 512 x 512) and equal
   to KP at the pixels' positions. Holds K2 (grid eval) and K1 (eval + classify)
   against their plain torch versions: on the nine-type tree of
   the first slice, on a tree holding each of the 55 node types, on
   seeded random CSG trees, and at every main-path grid shape (case grids
   exactly equal, distances within 1e-5 * max(1, |d|)). Holds K3, K4, K7s
   and K7w against theirs on K1's grid of each of those trees: ids, K3's
   three counts (active cubes, crossing edges, triangles), its two block
   offsets and its edge-rank directory, case bytes and tri_idx exactly
   equal, t, soup and welded vertices bit-identical, K7s and K7w in both
   call forms (with K3's result, and running K3 themselves). Holds all six once more on
   the second of flange 800's two fused soup slabs, at its shape and
   plane offset k0. Times every kernel against its plain version with
   CUDA events, in turns (plain, kernel, kernel, plain; K3's library call
   torch.nonzero inside them), at the five main-path grids, beside its
   bound from this run's sizes (bounds.py: the tree's
   operations per corner counted on the CPU, the MC kernels' from their
   plain versions on these inputs) and K1's time over K2's.
   The parametric forms K1p and KPp (one library per tree STRUCTURE, the
   continuous parameters a launch argument): built beside the baked ones
   for every 3D tree (KPp for the 2D trees too), ptxas' registers beside
   the baked kernels'; on every grid above K1p's cases exactly equal to
   plain's and to the baked K1's, its distances held to plain and compared
   with the baked K1's bit for bit (the count of differing floats is
   printed); KPp the same against plain and KP at the seeded points; then
   the SAME library with another tree's values (a structurally equal copy
   with every continuous parameter changed), held against that tree's
   plain version. Both are timed in turns against their baked forms at
   the five main grids and at 2^20 points, and the by-value form of the
   parameter argument against the pointer form.
   K5 and K5p (dual contouring, csrc/dc_mesh.cu; one library each per
   tree and per structure, built beside the others): held against their
   plain torch version (ops/dc_emit.py::dc_mesh_plain) on every 3D tree
   above and three more seeded random trees (ten random trees in all) at
   diag/64, on the bolt at resdiv 256, both QEF modes, on a slab of the
   bolt at k0 != 0 with a halo layer, and on grids of the bolt whose rows
   are DC_WORD_NX voxels (below, at and one past a 32-voxel word; one of
   them a slab with fewer owned layers than layers): edge ids, flips and
   the live-voxel
   count exactly equal, vertices within 1e-4 * res (the max |d| over res
   is printed), K5's grid pass equal to K2's in every float (the count of
   differing floats is printed); both through the wrapper dc_mesh. On
   every whole grid also K5's edge form, the wrapper dc_edges that the
   host_qef=True render reads, against dc_edges_plain: edge ids, flips, t
   and the raw normals exactly equal. Timed at the bolt's resdiv 256 and 384
   against the plain version, K5p in turns against K5 and by value against
   the pointer form. `python3 chip_smoke.py --dc` runs the dual contouring
   kernel rows alone (dc_study): those checks on the bolt's grids, then
   for every K5 call of the bolt's renders at resdiv 256, 384 and 512 (a
   call a chunk) each pass's device time beside its bound, registers and
   resident blocks, the K5 stage's wall split, and digests of K5's
   outputs; a copy of this script beside another checkout measures that
   checkout's K5, and equal digests show equal outputs.
3. Drives each FlatRenderer path, every launch count set to 0 just before
   it and read just after (golden triangle counts exact; SDF->STL wall ms,
   median of warm renders after two warm-ups):
   - render_compact + write_binary_stl_indexed (the main path) on flange
     resdiv 400, showerhead 350, flange 800, bolt 300, knurled 350;
   - render() (triangle soup) + write_binary_stl on flange 400, showerhead
     350 and flange 800 (two fused z-slabs);
   - render_indexed() + write_binary_stl_indexed on the same three (flange
     800 through the host weld of the soup);
   - render(fused=False) (the staged path: K2 on the whole grid, k0 = 0)
     on flange 800, equal bit for bit to the two fused slabs' soup;
   - the sphere golden (41,072 triangles, 68^3 evaluations);
   - a part cropped by with_bounds through the fallback: render_compact's
     decoder and the welded emit find unresolved owners, and the mesh is
     the welded soup;
   - render_compact with compact_cubes lowered so that it runs in z-slabs,
     equal to the whole-grid render;
   - evaluate_grid, the dense-field entry point, on three grids.
   Also holds the threaded native mc_decode against the single-threaded
   numpy mc_decode_plain bit for bit on the flange-800 payload.
   Then the point and 2D slice, at full width and with no `device`
   argument (the default is the card): new_sdf3(part).evaluate at 2^20
   seeded points on the four golden parts (one KP launch a call, equal to
   plain, and evaluate_device without a synchronising call), the
   reference's special-evaluator battery (eval.special.run_benchmarks:
   a 64-vertex polygon, 128 segments, 128 displacements, a deep 3D tree,
   and throughput_grid at 256^3), normals_central_diff on the bolt at
   2^18 points (six KP launches, bit for bit the six-call host form), the
   three example scenes through render_png_file_2d into a temporary
   directory (one K2-2D launch an image, the PNG read back and held to the
   array), the flange at resdiv 400 through pipeline.render_shader3d with
   an in-memory STL, and a Batcher round on two 2^20 buffers.
   Then the parametric slice, at full width: render_compact(parametric=
   True) on flange 400, showerhead 350, bolt 300 and knurled 350 (golden
   counts exact, ids, case bytes and t equal to the baked render's); an
   edit loop on the flange pinned by with_bounds, on render_compact and on
   render_indexed: three rebinds of one dimension each, every one rendered
   through the same library with no nvcc run and no library loaded, every
   mesh equal to a baked render of the edited tree (which builds: its
   edit-to-mesh time is printed beside the parametric one); one member of
   the showerhead's 130-hole loop group moved and seen in the mesh;
   ParametricSDF3.evaluate at 2^20 points on each golden part and on a
   structurally equal tree through one library; the host's time to pack a
   part's parameters and hash its structure.
   Then the dual contouring slice, on the default device:
   DualContourRenderer(bolt, diag/resdiv).render() at resdiv 256 (99,844
   triangles; again through host_qef=True), 384 (226,340) and 512
   (403,104, on the chunk route: one K5 launch a chunk; and as one whole
   grid with mono_voxels raised, bit-identical), each with its K5
   launches, what one K5 call runs on the card (at most six kernels and no
   memset), its one synchronising call before a fetch and its warm ms by
   stage (K5, fetch, host quad emission, STL encode: stages.dc); the
   parametric edit loop on the pinned part of the JAX package's
   test_dc_parametric_edit_zero_recompile: three rebinds through K5p with
   no compiler run and no library loaded, each mesh equal to the baked
   render of the edited tree within 1e-6.
   Then the pruned slice (render/pruned.py), on the default device:
   K6c (csrc/tile_prune.cu), K6a (csrc/tile_atlas.cu), their parametric
   forms K6cp and K6ap (built for every 3D tree beside its K1), the id map
   (csrc/tile_global_ids.cu) and K7s's tile mode were held in phase 2
   against their plain versions on every 3D tree at diag/64 with tiles of
   8 and of a size that leaves edge tiles overhanging (keep masks, counts,
   case bytes, ids and the soup exact, the number of differing floats and
   bytes printed; the atlas equal to K1's grid at the same corners bit for
   bit), and again at the main path's shapes: the coarse grid and the
   first batch of 2,048 kept tiles of every full-width render below.
   PrunedRenderer(part, diag/resdiv).render_compact() on flange 400,
   showerhead 350, bolt 300, knurled 350, flange 800 and flange 1000
   (102M cubes, golden 2,660,772): the triangle count beside the golden,
   the payload (ids, cases, t) equal to the dense compact_field_render
   payload, or where the prune drops cubes (a field that is not
   1-Lipschitz) to the plain pruned version, with the dropped ids; tiles
   kept, evaluations(), total_pruned() and batches equal to what the
   plain coarse pass's keep count gives, the synchronising calls of one
   compact_payload, launches per render exact (one K6c, then one K6a, K3,
   id map and K4 a batch), no fallback; warm SDF->STL in turns with the dense compact render, median
   of 5; device ms of one render by torch.profiler. render() on flange 400
   and showerhead 350 equal to FlatRenderer.render() as sorted rows,
   read_triangles' batch count; the edit loop (3 rebinds through
   render_compact(parametric=True) on the pinned flange: 0 compiler runs,
   0 libraries loaded, each mesh equal to the dense parametric render);
   each pruned kernel timed at flange 400 against its plain version.
   Then the raymarcher (visual/raymarch.py, pipeline/interactive.py): K8
   and K8p (csrc/raymarch.cu, built in phase 2 for the six parts and
   three random trees; the sixth, the GEB sculpture, is built inside
   spans.recording() and its textsdf.* spans and counters printed) were
   held in phase 2 against raymarch_plain at 128 x 128, aa 2, 196 steps:
   every pixel and every ray's evaluation count, K8p against K8, and
   K8p's library with a structurally equal tree's values. K8 and K8p are then held to raymarch_plain, in every
   pixel and every ray's evaluation count, at each frame the path below
   makes at the default view: 512 x 512 at aa 1 and at aa 3 (1536^2
   supersamples, box-filtered), the drag frame (256 x 256, 72 steps) and
   the ui frame (800 x 600), on the flange, showerhead, bolt, knurled
   cylinder, the sphere and the GEB sculpture. Then on those parts, on the
   default device: raymarch_image with the JAX package's defaults (512 x
   512, 196 steps, auto_relax, aa 1) and at aa 3 (one launch a frame, one synchronising
   call: the fetch; the image equal to plain's); the InteractiveViewer
   driven by on_press / on_move / on_scroll / on_release (drag frames 256
   x 256 at 72 steps, full frames 512 x 512 at aa 3, counted apart; no
   build after the first frame, which equals plain's; frame ms split into
   K8, fetch and host; pipelined drag frames in turns with synchronous
   ones); ui(part, UIConfig()) (24 frames at 800 x 600 and the GIF, read
   back); a slider viewer (params=[...]) through set_param: K8p only, no
   compiler run and no library loaded after the first frame, each edited
   512 x 512 aa 3 frame equal to the edited tree's plain version. Launches
   per frame are recorded as counted on each path. K8 is timed on each
   part at each of those frames (wrapper ms, CUDA-graph device ms) beside
   its bound from the evaluations it made (bounds.raymarch_ops), with the
   mean and most march steps per ray and the plain call's ms; at 512 x
   512 aa 1 also K8p in turns against K8. With each row: K8p's wrapper and
   device ms at every frame, how K8's own evaluation counts would fill
   32-ray warps (16 x 2, 8 x 4) and 128-ray blocks that run as long as
   their slowest ray (lane_efficiency), each form's registers, spills and
   resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
   the device work inside one call at 512 x 512 (a memset of the ray
   queue's counter, K8, and the box filter at aa 3: never more), and the
   lone-ray probe: the 512 x 512 aa 1 ray that evaluates most, alone in a
   1 x 1 frame, the floor of any design at that frame (rm_lone_ray).
   K8's counting form (ray_kernels.count_short_circuits) runs each frame
   too, held to plain like K8 (on a tree with no short-circuit site it is
   K8 itself). On a tree whose code has sites (a Difference that skips a
   subtrahend which cannot change its result, a union that skips a member
   whose point bound the members run before it undercut, codegen/cuda.py)
   each row also gives the share of lane evaluations and of warp turns
   that skipped at each site, and a second bound and device share on the
   work K8 runs: the counted work less each site's lane skips times its
   skipped function's ops (rm_site_ops), and at each bin-table loop of a
   threshold form (a Difference's subtrahend's translate-group loop, that
   walks only the members listed for the point's xy cell) the members a
   lane entry and a warp turn walked, less the members not walked. The
   shares are also read over the view mix of the benchmark's viewer cell
   (torch_bench/traffic/view.json), one frame a stratum at 512 x 512 aa 3
   (rm_short_circuits), with each union's sites summed, and with the
   share of lane edge evaluations and of warp edge turns of each polygon's
   edge loop that divided (ray_kernels.EDGE_DIVISIONS: an edge divides
   only where the clamp does not decide).
   `python3 chip_smoke.py --raymarch` runs these raymarch kernel rows
   alone; a copy of this script beside another checkout measures that
   checkout's K8.
4. Fails unless each kernel launched on every path that runs it, once per
   render and slab (the wrapper calls counted per render of each path are
   printed and held to what the path should make); prints the device
   launches that torch.profiler sees inside one call of each wrapper, with
   their device time (K7s must be one kernel, K7w at most two), and fails
   unless one soup render, one indexed render and one parametric indexed
   render synchronise once before their fetch
   (torch.cuda.set_sync_debug_mode). A time fails nothing.

The line before the last is nvidia-smi's card name and power limit; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

TOL = 1e-5  # relative to max(1, |d|): a CUDA library ulp vs torch's
#: random_tree seeds whose trees have a surface at resdiv 64 (others are
#: empty intersections, which test nothing)
FUZZ_SEEDS = (0, 3, 4, 5, 7, 9, 14)
#: three more random_tree seeds with a surface: K5's ten random trees
DC_EXTRA_SEEDS = (16, 17, 18)
#: the bolt's dual contouring goldens (tests/test_dual_contour.py:191,
#: tests/test_golden_scale.py:30-31); resdiv 512 is past mono_voxels
DC_GOLDENS = ((256, 99_844), (384, 226_340), (512, 403_104))
#: K5 against its plain version: max |vertex difference| / res
DC_TOL = 1e-4
#: voxels a row of K5's explicit small grids: below, at and one past a
#: 32-voxel word, and 2 + 64 (so row, word and plane ends fall apart)
DC_WORD_NX = (7, 32, 33, 65)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = out.stdout.strip().splitlines()
    if not lines:
        raise RuntimeError("nvidia-smi printed no card")
    return lines[0].strip()


def nine_type_tree(b, threads):
    """Small tree with the nine node types of the first slice."""
    import numpy as np

    hole = b.new_cylinder(0.2, 3.0)
    holes = [b.translate(hole, np.cos(a), np.sin(a), 0) for a in np.linspace(0, 6, 7)]
    ring = b.union(b.new_cylinder(1.5, 0.5), *holes)
    cut = b.scale(b.difference(b.new_cylinder(1.0, 2.0), b.new_cylinder(0.5, 3.0)), 0.8)
    body = b.intersection(b.smooth_union(0.2, ring, cut), b.new_cylinder(1.8, 1.8, 0.1))
    return b.union(body, threads.screw(b, 2.0, threads.ISO(d=2.0, p=0.4, ext=True)))


def every_type_tree(b, threads, with_bounds, Box):
    """Small tree holding each of the 55 node types of the Builder at
    least once; the 2D types enter through Extrusion and Revolution.
    Takes either package's Builder, threads module, with_bounds and Box,
    so the tests build it through both."""
    t2 = b.translate2d
    profile = b.union2d(
        b.new_circle(0.3),
        t2(b.new_line2d(-0.4, -0.2, 0.5, 0.35, 0.1), 0.1, 0.1),
        b.new_lines2d([[(-0.5, 0), (0, 0.3)], [(0, 0.3), (0.5, -0.2)]], 0.08),
        b.new_arc(0.6, math.pi / 1.5, 0.08),
        b.rotate2d(b.new_equilateral_triangle(0.5), 0.3),
        b.difference2d(b.new_rectangle(1.0, 0.6), b.new_hexagon(0.2)),
        b.intersection2d(b.new_octagon(0.7), b.new_ellipse(0.8, 0.45)),
        b.xor2d(b.new_diamond2d(1.0, 0.6), b.new_rounded_x(1.0, 0.1)),
        b.new_quadratic_bezier2d((-0.5, -0.2), (0.1, 0.6), (0.6, -0.1), 0.1),
        b.new_polygon([(-0.5, -0.4), (0.5, -0.5), (0.4, 0.5), (-0.3, 0.35)]),
        t2(b.array2d(b.new_circle(0.1), 0.3, 0.3, 2, 2), -0.6, -0.6),
        b.offset2d(b.new_circle(0.2), 0.02),
        b.symmetry2d(t2(b.new_circle(0.1), 0.5, 0.2), True, True),
        b.annulus(b.new_circle(0.5), 0.05),
        b.circular_array2d(t2(b.new_rectangle(0.1, 0.05), 0.7, 0), 5, 6),
        b.scale2d(b.new_hexagon(0.2), 1.5),
        b.translate_multi2d(b.new_circle(0.1), [(0, 0.5), (0.3, -0.5)]),
        b.elongate2d(b.new_circle(0.1), 0.3, 0.1),
        with_bounds(b.new_circle(0.2), Box([-0.2, -0.2], [0.2, 0.2])),
    )
    box = b.new_box(0.8, 0.6, 0.5, 0.05)
    ball = b.new_sphere(0.4)
    parts = [
        b.translate(b.extrude(profile, 0.4), 0, 0, 1.6),
        b.translate(b.revolve(t2(b.new_rectangle(0.3, 0.4), 0.9, 0), 0.1), 0, 0, -1.6),
        b.translate(b.xor(box, ball), 2.0, 0, 0),
        b.translate(b.new_box_frame(0.9, 0.8, 0.7, 0.1), -2.0, 0, 0),
        b.translate(b.new_torus(0.8, 0.2), 0, 2.0, 0),
        b.translate(b.new_hexagonal_prism(0.4, 0.3), 0, -2.0, 0),
        b.translate(b.smooth_union(0.1, b.new_cylinder(0.3, 0.8, 0.05), ball), 2.0, 2.0, 0),
        b.translate(b.smooth_difference(0.1, box, ball), -2.0, 2.0, 0),
        b.translate(b.smooth_intersect(0.1, box, b.new_sphere(0.45)), 2.0, -2.0, 0),
        b.translate(b.scale(b.difference(box, ball), 0.7), -2.0, -2.0, 0),
        b.translate(b.symmetry(b.translate(ball, 0.3, 0.2, 0), True, True, False), 0, 0, 3.2),
        b.translate(b.rotate(box, 0.7, (1, 0.3, 0.2)), 2.0, 0, 1.5),
        b.translate(b.offset(b.intersection(box, b.new_sphere(0.5)), -0.02), -2.0, 0, 1.5),
        b.translate(b.array(b.new_sphere(0.15), 0.4, 0.4, 0.4, 2, 2, 2), 0, 2.0, 1.5),
        b.translate(b.elongate(b.new_sphere(0.2), 0.3, 0.2, 0.1), 0, -2.0, 1.5),
        b.translate(b.shell(b.new_sphere(0.4), 0.05), 2.0, 0, -1.5),
        b.translate(
            b.circular_array(b.translate(b.new_box(0.2, 0.1, 0.3, 0), 0.6, 0, 0), 5, 7),
            -2.0, 0, -1.5,
        ),
        b.translate(b.twist(b.new_box(0.8, 0.3, 0.8, 0), 0.8), 0, 2.0, -1.5),
        b.translate(
            with_bounds(b.new_sphere(0.4), Box([-0.3, -0.3, -0.3], [0.3, 0.3, 0.3])),
            0, -2.0, -1.5,
        ),
        b.translate(threads.screw(b, 1.0, threads.ISO(d=1.2, p=0.25, ext=True)), 0, 0, -3.2),
    ]
    return b.union(*parts)


def recipes_2d(b, with_bounds, Box):
    """name -> a small 2D tree, one per 2D node type of the Builder (28
    types; the polygon twice, short and long enough for its scanned
    fold). Takes either package's Builder, with_bounds and Box, so the
    tests build them through both."""
    t2 = b.translate2d
    sq = b.new_rectangle(0.8, 0.5)
    a = [2 * math.pi * k / 12 for k in range(12)]
    star = [((1.0 + 0.3 * math.cos(3 * t)) * math.cos(t), (1.0 + 0.3 * math.cos(3 * t)) * math.sin(t))
            for t in a]
    return {
        "Circle": b.new_circle(0.8),
        "Line2D": b.new_line2d(-0.4, -0.2, 0.5, 0.35, 0.1),
        "Lines2D": b.new_lines2d([[(-0.5, 0), (0, 0.3)], [(0, 0.3), (0.5, -0.2)]], 0.08),
        "Arc2D": b.new_arc(0.6, math.pi / 1.5, 0.08),
        "EquilateralTriangle": b.new_equilateral_triangle(0.6),
        "Rectangle": b.new_rectangle(1.0, 0.6),
        "Hexagon2D": b.new_hexagon(0.5),
        "Octagon2D": b.new_octagon(0.7),
        "Ellipse2D": b.new_ellipse(0.8, 0.45),
        "Diamond2D": b.new_diamond2d(1.0, 0.6),
        "RoundedX2D": b.new_rounded_x(1.0, 0.1),
        "QuadraticBezier2D": b.new_quadratic_bezier2d((-0.5, -0.2), (0.1, 0.6), (0.6, -0.1), 0.1),
        "Polygon2D": b.new_polygon([(0.0, 0.0), (1.0, 0.1), (0.8, 0.9), (0.2, 1.1), (-0.3, 0.5)]),
        "Polygon2D-scan": b.new_polygon(star),
        "OpUnion2D": b.union2d(b.new_circle(0.4), t2(sq, 0.3, 0.1), b.new_hexagon(0.3)),
        "Difference2D": b.difference2d(sq, b.new_circle(0.2)),
        "Intersection2D": b.intersection2d(sq, b.new_circle(0.35)),
        "Xor2D": b.xor2d(sq, t2(b.new_circle(0.3), 0.2, 0)),
        "Array2D": b.array2d(b.new_circle(0.2), 0.5, 0.6, 3, 2),
        "Offset2D": b.offset2d(sq, -0.05),
        "Translate2D": t2(b.new_hexagon(0.4), 0.2, -0.3),
        "Rotation2D": b.rotate2d(sq, 0.6),
        "Symmetry2D": b.symmetry2d(t2(b.new_circle(0.3), 0.4, 0.2), True, True),
        "Annulus2D": b.annulus(b.new_circle(0.6), 0.1),
        "CircularArray2D": b.circular_array2d(t2(b.new_rectangle(0.3, 0.2), 0.8, 0), 5, 6),
        "Scale2D": b.scale2d(b.new_hexagon(0.4), 1.7),
        "TranslateMulti2D": b.translate_multi2d(b.new_circle(0.2), [(0, 0), (0.5, 0.1), (-0.3, 0.4)]),
        "Elongate2D": b.elongate2d(b.new_circle(0.3), 0.4, 0.2),
        "BoundsOverride2": with_bounds(b.new_circle(0.7), Box([-0.5, -0.6], [0.6, 0.5])),
    }


def random_tree(b, rng):
    """A seeded random CSG tree for the card: random primitives (2D
    profiles extruded or revolved) combined by the boolean and smooth
    ops, then one or two random domain ops, as the JAX package's path
    fuzz builds them (tests/test_fuzz_paths.py). None when the Builder
    rejects the draw."""
    def profile():
        k = int(rng.integers(3))
        if k == 0:
            return b.new_circle(float(rng.uniform(0.2, 0.5)))
        if k == 1:
            return b.new_rectangle(float(rng.uniform(0.3, 0.8)), float(rng.uniform(0.3, 0.8)))
        return b.new_hexagon(float(rng.uniform(0.2, 0.5)))

    prims = [
        lambda: b.new_sphere(float(rng.uniform(0.3, 1.0))),
        lambda: b.new_box(*(float(x) for x in rng.uniform(0.4, 1.2, 3)), 0.0),
        lambda: b.new_cylinder(float(rng.uniform(0.2, 0.6)), float(rng.uniform(0.5, 1.5)), 0.0),
        lambda: b.new_torus(float(rng.uniform(0.5, 0.9)), float(rng.uniform(0.1, 0.25))),
        lambda: b.new_hexagonal_prism(float(rng.uniform(0.3, 0.7)), float(rng.uniform(0.4, 1.0))),
        lambda: b.extrude(profile(), float(rng.uniform(0.4, 1.2))),
        lambda: b.revolve(b.translate2d(profile(), float(rng.uniform(0.8, 1.5)), 0.0),
                          float(rng.uniform(0.0, 0.4))),
    ]

    def leaf():
        s = prims[int(rng.integers(len(prims)))]()
        return b.translate(s, *(float(x) for x in rng.uniform(-0.5, 0.5, 3)))

    def unary(t):
        k = int(rng.integers(8))
        if k == 0:
            ax = rng.normal(size=3)
            ax /= math.sqrt(float((ax * ax).sum()))
            return b.rotate(t, float(rng.uniform(0, 3)), tuple(float(a) for a in ax))
        if k == 1:
            return b.scale(t, float(rng.uniform(0.6, 1.5)))
        if k == 2:
            return b.shell(t, float(rng.uniform(0.03, 0.1)))
        if k == 3:
            return b.twist(t, float(rng.uniform(-0.5, 0.5)))
        if k == 4:
            n_div = int(rng.integers(3, 9))
            return b.circular_array(b.translate(t, float(rng.uniform(1.5, 2.5)), 0.0, 0.0),
                                    int(rng.integers(2, n_div + 1)), n_div)
        if k == 5:
            return b.elongate(t, *(float(x) for x in rng.uniform(0.05, 0.4, 3)))
        if k == 6:
            return b.symmetry(t, True, bool(rng.integers(2)), False)
        nx, ny, nz = (int(x) for x in rng.integers(1, 3, 3))
        return b.array(t, *(float(x) for x in rng.uniform(1.8, 2.4, 3)), nx, ny, nz)

    ops = [b.union, b.difference, b.intersection,
           lambda x, y: b.smooth_union(float(rng.uniform(0.02, 0.2)), x, y),
           lambda x, y: b.smooth_difference(float(rng.uniform(0.02, 0.2)), x, y)]
    t = leaf()
    for _ in range(int(rng.integers(1, 4))):
        t = ops[int(rng.integers(len(ops)))](t, leaf())
    for _ in range(int(rng.integers(1, 3))):
        t = unary(t)
    if b.err():
        return None
    bb = t.bounds()
    if bb.is_empty() or not math.isfinite(bb.diagonal()):
        return None
    return t


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn over `reps` launches after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain):
    """(kernel ms, plain ms) by CUDA events, in turns: plain, kernel,
    kernel, plain; the better of each pair."""
    p1 = cuda_ms(plain, 3)
    k1, k2 = cuda_ms(kernel, 10), cuda_ms(kernel, 10)
    return min(k1, k2), min(p1, cuda_ms(plain, 3))


def perturbed(tree):
    """A structurally equal copy of `tree` with every continuous parameter
    changed (x * 1.05 + 0.01; a transform's inverse follows its matrix)."""
    import copy

    import numpy as np
    from gsdf_tpu_torch.eval.parametric import param_spec

    other = copy.deepcopy(tree)
    edits: dict = {}
    for node, name, _ in param_spec(other):
        if name in node.PARAMS:
            old = np.asarray(getattr(node, name), np.float32)
            edits.setdefault(node, {})[name] = old * np.float32(1.05) + np.float32(0.01)
    return other.rebind(edits)


def seeded_points(tree, n, seed, dev):
    """(n, NDIM) float32 points drawn from a seed in the tree's bounds
    grown by 10%, as a tensor on `dev`."""
    import numpy as np
    import torch

    bb = tree.bounds()
    lo, hi = np.asarray(bb.min, np.float64), np.asarray(bb.max, np.float64)
    pad = 0.1 * (hi - lo)
    pts = np.random.default_rng(seed).uniform(lo - pad, hi + pad, (n, len(lo)))
    return torch.from_numpy(pts.astype(np.float32)).to(dev)


def held_to_plain(label, d, ref):
    """Max |d - ref| of a kernel's distances against its plain version's;
    raises on a non-finite value or past TOL * max(1, |ref|)."""
    import torch

    if not bool(torch.isfinite(d).all()):
        raise RuntimeError(f"{label}: non-finite distances")
    diff = (d - ref).abs()
    rel = float((diff / ref.abs().clamp(min=1.0)).max())
    log(f"  {label}: max|d-plain| {float(diff.max()):.3e} (rel {rel:.3e}), "
        f"differing floats {int((diff > 0).sum())} of {d.numel()}")
    if rel > TOL:
        raise RuntimeError(f"{label}: distances off by {rel:.3e} > {TOL}")
    return float(diff.max())


def compare_points(name, tree, dev, pk, n=1 << 16):
    """KP vs its plain version at n seeded points of the tree's bounds."""
    import torch

    pos = seeded_points(tree, n, 1, dev)
    d = pk.evaluate_points(tree, pos, dev)
    ref = pk.point_eval_plain(tree, pos)
    torch.cuda.synchronize()
    return held_to_plain(f"point_eval      {name:22s} {n} points", d, ref)


def compare_points_param(name, tree, other, dev, pk, n=1 << 16):
    """KPp at n seeded points: against plain, against the baked KP (the
    count of floats that differ is returned), and the same library with
    `other`'s values (a structurally equal tree) against other's plain."""
    import torch

    pos = seeded_points(tree, n, 1, dev)
    d = pk.evaluate_points(tree, pos, dev, parametric=True)
    baked = pk.evaluate_points(tree, pos, dev)
    err = held_to_plain(f"point_eval_param {name:21s} {n} points", d,
                        pk.point_eval_plain(tree, pos))
    od = pk.evaluate_points(other, pos, dev, parametric=True)
    err = max(err, held_to_plain(f"point_eval_param {name:21s} other values", od,
                                 pk.point_eval_plain(other, pos)))
    torch.cuda.synchronize()
    return err, int((d != baked).sum())


def compare_field(name, tree, width, height, dev, pk):
    """K2-2D vs its plain version on the tree's pixel grid, and KP at the
    pixels' positions equal to K2-2D bit for bit."""
    import torch

    d = pk.distance_field(tree, width, height, dev)
    pos = pk.pixel_positions(tree, width, height, dev).reshape(-1, 2).contiguous()
    ref = pk.distance_field_plain(tree, width, height, dev)
    at_pixels = pk.evaluate_points(tree, pos, dev).reshape(height, width)
    torch.cuda.synchronize()
    err = held_to_plain(f"grid_eval_2d    {name:22s} {width}x{height}", d, ref)
    if not torch.equal(at_pixels, d):
        raise RuntimeError(f"{name}: KP at the pixels' positions differs from K2-2D")
    return err


class HostOnly:
    """An evaluator with `evaluate` alone, as the host-side caches are:
    normals_central_diff gives it the six-call host-to-host form."""

    def __init__(self, sdf):
        self.evaluate = sdf.evaluate


def grid_of(tree, resdiv, dev, slab):
    """(renderer, corner shape, k0) of the whole grid at diag/resdiv, or of
    its fused soup slab number `slab` (FlatRenderer.soup_slabs)."""
    from gsdf_tpu_torch.render.flat import FlatRenderer

    fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)
    if slab is None:
        return fr, fr.shape(), 0
    k0, shape = fr.soup_slabs()[slab]
    return fr, shape, k0


def compare(name, tree, resdiv, dev, gk, slab=None, other=None):
    """K2 and K1 vs their plain versions on one grid (or soup slab, at its
    plane offset k0), and KP at the grid's positions equal to K2 bit for
    bit (grids up to 8M corners: their positions are 12 B a corner); K1p
    vs plain and vs K1, and through the same library with `other`'s values
    (a structurally equal tree) vs other's plain; returns the max absolute
    error of each, with the floats in which K1p differs from K1, and raises
    on a disagreement."""
    import torch
    from gsdf_tpu_torch.eval import point_kernels as pk

    fr, shape, k0 = grid_of(tree, resdiv, dev, slab)
    d2 = gk.evaluate_grid(tree, fr.origin, fr.res, shape, dev, k0)
    if d2.numel() <= 8_000_000:
        pos = gk.grid_positions(fr.origin, fr.res, shape, dev, k0).reshape(-1, 3).contiguous()
        at_corners = pk.evaluate_points(tree, pos, dev).reshape(shape)
        if not torch.equal(at_corners, d2):
            raise RuntimeError(f"{name}: KP at the grid's positions differs from K2")
        log(f"  point_eval      {name:14s} grid {shape} k0 {k0}: equal to K2 bit for bit")
        del pos, at_corners
    d1, c1 = gk.classified_grid(tree, fr.origin, fr.res, shape, dev, k0)
    pd, pc = gk.classified_grid_plain(tree, fr.origin, fr.res, shape, dev, k0)
    torch.cuda.synchronize()
    out = {kname: held_to_plain(f"{kname:15s} {name:14s} grid {shape} k0 {k0}", d, pd)
           for kname, d in (("grid_eval", d2), ("classified_grid", d1))}
    n_case_diff = int((c1 != pc).sum())
    log(
        f"  classified_grid {name:14s} cases: {n_case_diff} differing of {c1.numel()}, "
        f"{int((c1 != 0).sum())} active"
    )
    if n_case_diff:
        raise RuntimeError(f"classified_grid {name}: case grid differs from plain")
    if not torch.equal(d1, d2):
        raise RuntimeError(f"{name}: K1 and K2 distances differ")
    del d2
    grid = (fr.origin, fr.res, shape, dev, k0)
    dp, cp = gk.classified_grid(tree, *grid, parametric=True)
    out["classified_grid_param"] = held_to_plain(
        f"{'classified_grid_param':15s} {name:14s} grid {shape} k0 {k0}", dp, pd)
    differing = int((dp != d1).sum())
    log(f"  classified_grid_param {name:14s}: cases {int((cp != pc).sum())} differing from "
        f"plain, {int((cp != c1).sum())} from the baked K1; distances differ from the baked "
        f"K1's in {differing} floats of {dp.numel()} (max |delta| {_max_abs(dp, d1):.3e})")
    if not (torch.equal(cp, pc) and torch.equal(cp, c1)):
        raise RuntimeError(f"classified_grid_param {name}: case grid differs")
    del dp, cp, d1, c1, pd, pc
    od, oc = gk.classified_grid(other, *grid, parametric=True)
    opd, opc = gk.classified_grid_plain(other, *grid)
    torch.cuda.synchronize()
    out["classified_grid_param"] = max(out["classified_grid_param"], held_to_plain(
        f"{'classified_grid_param':15s} {name:14s} other values", od, opd))
    if not torch.equal(oc, opc):
        raise RuntimeError(f"classified_grid_param {name}: another tree's values through the "
                           f"same library: {int((oc != opc).sum())} cases differ from plain")
    log(f"  classified_grid_param {name:14s} other values: cases equal to plain, "
        f"{int((oc != 0).sum())} active")
    return out, differing


#: the main-path grids, where every kernel is timed
MAIN_GRIDS = (("flange", 400), ("showerhead", 350), ("flange", 800), ("bolt", 300),
              ("knurled", 350))
#: (name, route source, replaced TPU-side function "file:line")
KERNELS = (
    ("classified_grid", "gsdf_tpu_torch/csrc/classified_grid.cu",
     "gsdf_tpu/eval/pallas_grid.py:187"),
    ("grid_eval", "gsdf_tpu_torch/csrc/grid_eval.cu", "gsdf_tpu/eval/pallas_grid.py:108"),
    ("point_eval", "gsdf_tpu_torch/csrc/point_eval.cu", "gsdf_tpu/eval/evaluator.py:44"),
    ("grid_eval_2d", "gsdf_tpu_torch/csrc/grid_eval_2d.cu", "gsdf_tpu/render/image.py:53"),
    ("compact_active", "gsdf_tpu_torch/csrc/compact_active.cu", "gsdf_tpu/ops/mc_emit.py:190"),
    ("compact_emit", "gsdf_tpu_torch/csrc/compact_emit.cu",
     "gsdf_tpu/ops/compact_field.py:217"),
    ("emit_soup", "gsdf_tpu_torch/csrc/emit_soup.cu", "gsdf_tpu/ops/mc_emit.py:332"),
    ("emit_welded", "gsdf_tpu_torch/csrc/emit_welded.cu",
     "gsdf_tpu/ops/fused_welded.py:43"),
    # the parametric forms: the operand-bound executables cached by structure
    ("classified_grid_param", "gsdf_tpu_torch/csrc/classified_grid.cu",
     "gsdf_tpu/ops/compact_field.py:438"),
    ("point_eval_param", "gsdf_tpu_torch/csrc/point_eval.cu",
     "gsdf_tpu/eval/parametric.py:162"),
    # dual contouring's device stage, baked and parametric
    ("dc_mesh", "gsdf_tpu_torch/csrc/dc_mesh.cu", "gsdf_tpu/render/dual_contour.py:179"),
    ("dc_mesh_param", "gsdf_tpu_torch/csrc/dc_mesh.cu",
     "gsdf_tpu/render/dual_contour.py:588"),
    # the pruned renderer: coarse pass and tile atlas, baked and parametric,
    # and the atlas's id map
    ("tile_prune", "gsdf_tpu_torch/csrc/tile_prune.cu", "gsdf_tpu/render/pruned.py:41"),
    ("tile_atlas", "gsdf_tpu_torch/csrc/tile_atlas.cu", "gsdf_tpu/render/pruned.py:101"),
    ("tile_prune_param", "gsdf_tpu_torch/csrc/tile_prune.cu", "gsdf_tpu/render/pruned.py:75"),
    ("tile_atlas_param", "gsdf_tpu_torch/csrc/tile_atlas.cu", "gsdf_tpu/render/pruned.py:236"),
    ("tile_global_ids", "gsdf_tpu_torch/csrc/tile_global_ids.cu",
     "gsdf_tpu/ops/compact_field.py:311"),
    # the raymarcher, baked and parametric
    ("raymarch", "gsdf_tpu_torch/csrc/raymarch.cu", "gsdf_tpu/visual/raymarch.py:26"),
    ("raymarch_param", "gsdf_tpu_torch/csrc/raymarch.cu", "gsdf_tpu/visual/raymarch.py:151"),
)


def mc_versions(dist, cases, comp, fr, k0=0):
    """(kernel, plain) callables of K3, K4, K7s and K7w on one grid whose
    first plane is plane k0 of the whole grid; comp is K3's result with
    its edge ranks (None where only K3 is called). The emit kernels take
    K3's counts and block offsets, as the paths hand them on."""
    from gsdf_tpu_torch.ops import compact_field, fused_welded, mc_emit

    o, r = fr.origin, fr.res
    ids = None if comp is None else comp.ids
    return {
        "compact_active": (lambda: mc_emit.compact_active(cases),
                           lambda: mc_emit.compact_active_plain(cases)),
        "compact_emit": (lambda: compact_field.compact_emit(dist, cases, ids, comp.n_t,
                                                            comp.offsets),
                         lambda: compact_field.compact_emit_plain(dist, cases, ids)),
        "emit_soup": (lambda: mc_emit.emit_triangles(dist, cases, ids, o, r, k0, comp.n_tris,
                                                     comp.tri_offsets),
                      lambda: mc_emit.emit_triangles_plain(dist, cases, ids, o, r, k0)),
        "emit_welded": (lambda: fused_welded.emit_welded(dist, cases, ids, o, r, k0, comp=comp),
                        lambda: fused_welded.emit_welded_plain(dist, cases, ids, o, r, k0)),
    }


def _max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def same_compaction(a, b) -> bool:
    """Two results of K3 equal in every field both hold."""
    import torch

    return (torch.equal(a.ids, b.ids) and (a.n_t, a.n_tris) == (b.n_t, b.n_tris)
            and torch.equal(a.offsets, b.offsets) and torch.equal(a.tri_offsets, b.tri_offsets)
            and (a.edge_ranks is None or b.edge_ranks is None
                 or torch.equal(a.edge_ranks, b.edge_ranks)))


def mc_compare(name, tree, resdiv, dev, gk, slab=None):
    """K3, K4, K7s and K7w vs their plain versions on K1's grid (or soup
    slab, at its plane offset k0): ids, K3's counts, block offsets and edge
    ranks, case bytes and tri_idx exact, t and vertices bit-identical; K7s
    and K7w also in the form that runs K3 itself. Returns the max absolute
    error of each kernel's output, the grid, K3's result, the renderer and
    the output sizes (for timing and bounds); raises on a disagreement."""
    import torch
    from gsdf_tpu_torch.ops import fused_welded, mc_emit

    fr, shape, k0 = grid_of(tree, resdiv, dev, slab)
    dist, cases = gk.classified_grid(tree, fr.origin, fr.res, shape, dev, k0)
    comp = mc_emit.compact_active(cases, edge_ranks=True)
    ref_comp = mc_emit.compact_active_plain(cases, edge_ranks=True)
    fns = mc_versions(dist, cases, comp, fr, k0)
    bare = fns["compact_active"][0]()  # as the soup and compact paths call it
    (idx8, t), (ref_idx8, ref_t) = (f() for f in fns["compact_emit"])
    tris, ref_tris = (f() for f in fns["emit_soup"])
    (verts, tri, unres), (ref_verts, ref_tri, ref_unres) = (f() for f in fns["emit_welded"])
    ids = comp.ids
    tris3 = mc_emit.emit_triangles(dist, cases, ids, fr.origin, fr.res, k0)
    verts3, tri3, unres3 = fused_welded.emit_welded(dist, cases, ids, fr.origin, fr.res, k0)
    torch.cuda.synchronize()
    unres, ref_unres = int(unres), int(ref_unres)
    checks = {
        "compact_active": (same_compaction(comp, ref_comp) and same_compaction(bare, ref_comp)
                           and bare.edge_ranks is None
                           and (comp.n_t, comp.n_tris) == (len(ref_verts), len(ref_tris)),
                           max(_max_abs(ids, ref_comp.ids),
                               _max_abs(comp.offsets, ref_comp.offsets),
                               _max_abs(comp.tri_offsets, ref_comp.tri_offsets),
                               _max_abs(comp.edge_ranks, ref_comp.edge_ranks))),
        "compact_emit": (torch.equal(idx8, ref_idx8) and torch.equal(t, ref_t),
                         max(_max_abs(t, ref_t), _max_abs(idx8, ref_idx8))),
        "emit_soup": (torch.equal(tris, ref_tris) and torch.equal(tris3, ref_tris),
                      _max_abs(tris, ref_tris)),
        "emit_welded": (torch.equal(verts, ref_verts) and torch.equal(tri, ref_tri)
                        and unres == ref_unres and torch.equal(verts3, ref_verts)
                        and torch.equal(tri3, ref_tri) and int(unres3) == ref_unres,
                        max(_max_abs(verts, ref_verts), _max_abs(tri, ref_tri))),
    }
    log(f"  MC kernels {name:14s}: {len(ids)} active, {comp.n_t} t, {len(tris)} triangles, "
        f"{len(verts)} welded vertices, {unres} unresolved corners; "
        + ", ".join(f"{k} {'exact' if ok else 'DIFFERS'}" for k, (ok, _) in checks.items()))
    bad = [k for k, (ok, _) in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{name}: {bad} differ from their plain versions")
    sizes = {"corners": dist.numel(), "cubes": cases.numel(), "active": len(ids),
             "n_t": len(t), "tris": len(tris), "verts": len(verts)}
    return {k: err for k, (_, err) in checks.items()}, (dist, cases, comp, fr, sizes)


#: the pruned renderer's full-width renders (PrunedRenderer.render_compact):
#: the compact goldens, and flange 1000, the size the JAX package's
#: examples/prune_scale.py was written for
PRUNED_GRIDS = (("flange", 400), ("showerhead", 350), ("bolt", 300), ("knurled", 350),
                ("flange", 800), ("flange", 1000))
#: the kernels of one pruned compact render: K6c once, then per batch K6a,
#: K3, the id map and K4 (and the parametric forms of K6c, K6a)
PRUNED_PATH = ("tile_prune", "tile_atlas", "compact_active", "tile_global_ids", "compact_emit")
PRUNED_PARAM_PATH = ("tile_prune_param", "tile_atlas_param") + PRUNED_PATH[2:]


def tiles_of(keep, dev):
    """The kept tiles of a keep mask as the renderer lists them: (T, 3)
    int32 [i, j, k] rows in np.argwhere order, on `dev`."""
    import numpy as np
    import torch

    rows = np.argwhere(keep.cpu().numpy())[:, ::-1]
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(dev)


def atlas_against_grid(dist, cases, tiles, S, d1, c1):
    """(floats, case bytes) in which a tile atlas differs from the whole
    grid (d1 corners, c1 cases, as K1 made them) at the same global
    corners and cubes inside the grid."""
    import torch

    nk, nj, ni = d1.shape
    T, P, dev = tiles.shape[0], S + 1, dist.device
    t = tiles.to(torch.int64)
    loc = torch.arange(P, device=dev)
    gi, gj, gk = (t[:, c, None] * S + loc for c in range(3))  # (T, P) each
    inside = ((gk < nk)[:, :, None, None] & (gj < nj)[:, None, :, None]
              & (gi < ni)[:, None, None, :])
    lin = (gk.clamp(max=nk - 1)[:, :, None, None] * nj + gj.clamp(max=nj - 1)[:, None, :, None]) \
        * ni + gi.clamp(max=ni - 1)[:, None, None, :]
    floats = int(((dist.view(T, P, P, P) != d1.reshape(-1)[lin]) & inside).sum())
    ka = torch.arange(T * P - 1, device=dev)
    lk, cloc = ka % P, torch.arange(S, device=dev)
    ck = t[ka // P, 2] * S + lk
    cj, ci = t[ka // P, 1, None] * S + cloc, t[ka // P, 0, None] * S + cloc
    cube_in = (((lk < S) & (ck < nk - 1))[:, None, None] & (cj < nj - 1)[:, :, None]
               & (ci < ni - 1)[:, None, :])
    clin = (ck.clamp(max=nk - 2)[:, None, None] * (nj - 1) + cj.clamp(max=nj - 2)[:, :, None]) \
        * (ni - 1) + ci.clamp(max=ni - 2)[:, None, :]
    bytes_ = int(((cases != c1.reshape(-1)[clin]) & cube_in).sum())
    return floats, bytes_


def pruned_compare(name, tree, other, resdiv, S, dev, gk, first_batch=False):
    """K6c and K6a (baked, parametric, and the parametric library with
    `other`'s values: a structurally equal tree), the id map and K7s's tile
    mode against their plain versions on the card at tile size S; K6a's
    atlas and case grid against K1's whole grid at the same corners and
    cubes. Keep masks, counts, case bytes, ids and the soup must be equal,
    the atlas's distances within TOL of plain (an ulp of CUDA's atan2f, as
    for K1) and equal to K1's bit for bit. The atlas holds every kept tile,
    or with first_batch the renderer's first batch of them (the main
    path's shapes). Returns ({kernel: max abs error}, {what: floats or
    bytes differing})."""
    import torch
    from gsdf_tpu_torch.ops import compact_field, mc_emit
    from gsdf_tpu_torch.render.flat import FlatRenderer
    from gsdf_tpu_torch.render.pruned import PrunedRenderer

    pr = PrunedRenderer(tree, tree.bounds().diagonal() / resdiv, tile_size=S, device=dev)
    shape, dims, grid = (pr.tz, pr.ty, pr.tx), pr.dims(), (pr.origin, pr.res, S)
    fr = FlatRenderer(tree, pr.res, dev)
    d1, c1 = gk.classified_grid(tree, fr.origin, fr.res, fr.shape(), dev)
    err = {}
    diff = {"keep bytes": 0, "atlas floats from plain": 0, "atlas floats from K1": 0,
            "case bytes": 0, "ids": 0, "tile soup floats": 0}
    tiles = None
    for label, t, par in (("", tree, False), ("_param", tree, True), ("_param", other, True)):
        keep, count = gk.coarse_keep(t, *grid, shape, dev, par)
        pkeep, pcount = gk.coarse_keep_plain(t, *grid, shape, dev)
        torch.cuda.synchronize()
        n = int((keep != pkeep).sum()) + int(int(count) != int(pcount))
        diff["keep bytes"] += n
        err["tile_prune" + label] = max(err.get("tile_prune" + label, 0.0), float(n))
        if n:
            raise RuntimeError(f"tile_prune{label} {name} S={S}: {n} keep bytes or the count "
                               "differ from plain")
        if tiles is None:
            n_kept = int(count)
            tiles = tiles_of(keep, dev)[: pr.tiles_per_batch if first_batch else None]
        if not len(tiles):
            raise RuntimeError(f"{name} S={S}: no tile kept, nothing compared")
        dist, cases = gk.tile_grid(t, tiles, *grid, dims, dev, par)
        pdist, pcases = gk.tile_grid_plain(t, tiles, *grid, dims, dev)
        torch.cuda.synchronize()
        err["tile_atlas" + label] = max(err.get("tile_atlas" + label, 0.0), held_to_plain(
            f"tile_atlas{label:6s} {name:14s} S={S} T={len(tiles)}"
            + (" other values" if t is other else ""), dist, pdist))
        diff["atlas floats from plain"] += int((dist != pdist).sum())
        n_case = int((cases != pcases).sum())
        diff["case bytes"] += n_case
        if t is tree:  # the atlas is K1's grid at the same corners, bit for bit
            if not par:
                atlas = dist, cases  # the id map and K7s's tile mode run on this one
            floats, bytes_ = atlas_against_grid(dist, cases, tiles, S, d1, c1)
            diff["atlas floats from K1"] += floats
            n_case += bytes_
        if n_case or diff["atlas floats from K1"]:
            raise RuntimeError(f"tile_atlas{label} {name} S={S}: {n_case} case bytes differ "
                               f"from plain or K1, {diff['atlas floats from K1']} floats from K1")
    dist, cases = atlas
    comp = mc_emit.compact_active(cases)
    ids = compact_field.tile_global_ids(comp.ids, tiles, S, dims)
    pids = compact_field.tile_global_ids_plain(comp.ids, tiles, S, dims)
    tris = mc_emit.emit_triangles(dist, cases, comp.ids, pr.origin, pr.res, 0, comp.n_tris,
                                  comp.tri_offsets, tiles=tiles)
    ptris = mc_emit.emit_triangles_plain(dist, cases, comp.ids, pr.origin, pr.res, 0, tiles)
    torch.cuda.synchronize()
    diff["ids"] += int((ids != pids).sum())
    same_soup = tris.shape == ptris.shape
    diff["tile soup floats"] += int((tris != ptris).sum()) if same_soup else tris.numel() + 1
    err["tile_global_ids"] = _max_abs(ids, pids)
    err["emit_soup"] = _max_abs(tris, ptris) if same_soup else float("inf")
    if diff["ids"] or diff["tile soup floats"]:
        raise RuntimeError(f"{name} S={S}: the id map or K7s's tile mode differs from plain: "
                           f"{diff}")
    log(f"  pruned kernels {name:14s} resdiv {resdiv} S={S:2d}: {pr.tx * pr.ty * pr.tz} tiles, "
        f"{n_kept} kept, {len(tiles)} in the atlas, {len(comp.ids)} active, {len(tris)} "
        f"triangles; differing from plain or K1: {diff}")
    return err, diff


def pruned_payload_plain(tree, res, dev):
    """The pruned compact payload through the plain versions alone (K6c,
    K6a, K3, the id map, K4) on `dev`, batch by batch as the renderer runs:
    (ids, cases, t)."""
    import numpy as np
    from gsdf_tpu_torch.eval import grid_kernels as gk
    from gsdf_tpu_torch.ops import compact_field
    from gsdf_tpu_torch.render.pruned import PrunedRenderer

    pr = PrunedRenderer(tree, res, device=dev)
    keep, _ = gk.coarse_keep_plain(tree, pr.origin, pr.res, pr.S, (pr.tz, pr.ty, pr.tx), dev)
    tiles = tiles_of(keep, dev)
    parts = []
    for start in range(0, len(tiles), pr.tiles_per_batch):
        batch = tiles[start : start + pr.tiles_per_batch]
        dist, cases = gk.tile_grid_plain(tree, batch, pr.origin, pr.res, pr.S, pr.dims(), dev)
        ids, idx8, t = compact_field.tile_compact_emit_plain(dist, cases, batch, pr.dims())
        parts.append((ids.cpu().numpy().view(np.uint32), idx8.cpu().numpy(), t.cpu().numpy()))
    return compact_field.merge_compact_payloads(parts)


def graph_ms(fn, reps: int = 20) -> float | None:
    """Device ms of one call of fn from a CUDA graph of `reps` calls,
    replayed three times between CUDA events: the kernels' time with the
    host's launch work taken out (fn must not synchronise). None, logged,
    where the capture fails: a time fails nothing."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"  graph timing: {e}")
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def pruned_kernel_times(tree, resdiv, dev, gk, n_params, card):
    """Each pruned kernel on the part at diag/resdiv against its plain
    version, in turns (plain, kernel, kernel, plain): K6c on the coarse
    grid, K6a, the id map and K7s's tile mode on the first batch of kept
    tiles; the parametric forms also in turns against the baked ones.
    "ms" is the wrapper's by CUDA events (host-bound on these sizes),
    "graph_ms" the device time of one call from a CUDA graph (graph_ms),
    beside the bound (ops of the plain version on these inputs, bytes by
    bounds.kernel_bytes). Phase 2 holds every kernel's output on these
    same inputs to its plain version (pruned_compare, first_batch=True).
    Returns {kernel: row}."""
    import torch
    import bounds
    from gsdf_tpu_torch.ops import compact_field, mc_emit
    from gsdf_tpu_torch.render.pruned import PrunedRenderer

    pr = PrunedRenderer(tree, tree.bounds().diagonal() / resdiv, device=dev)
    shape, dims, S = (pr.tz, pr.ty, pr.tx), pr.dims(), pr.S
    batch = tiles_of(gk.coarse_keep(tree, pr.origin, pr.res, S, shape, dev)[0],
                     dev)[: pr.tiles_per_batch]
    coarse = (tree, pr.origin, pr.res, S, shape, dev)
    atlas = (tree, batch, pr.origin, pr.res, S, dims, dev)
    dist, cases = gk.tile_grid(*atlas)
    comp = mc_emit.compact_active(cases)
    o, r = pr.origin, pr.res
    versions = {
        "tile_prune": (lambda: gk.coarse_keep(*coarse), lambda: gk.coarse_keep_plain(*coarse)),
        "tile_prune_param": (lambda: gk.coarse_keep(*coarse, True),
                             lambda: gk.coarse_keep_plain(*coarse)),
        "tile_atlas": (lambda: gk.tile_grid(*atlas), lambda: gk.tile_grid_plain(*atlas)),
        "tile_atlas_param": (lambda: gk.tile_grid(*atlas, True),
                             lambda: gk.tile_grid_plain(*atlas)),
        "tile_global_ids": (lambda: compact_field.tile_global_ids(comp.ids, batch, S, dims),
                            lambda: compact_field.tile_global_ids_plain(comp.ids, batch, S,
                                                                        dims)),
        "emit_soup_tiles": (lambda: mc_emit.emit_triangles(dist, cases, comp.ids, o, r, 0,
                                                           comp.n_tris, comp.tri_offsets,
                                                           tiles=batch),
                            lambda: mc_emit.emit_triangles_plain(dist, cases, comp.ids, o, r,
                                                                 0, batch)),
    }
    T, P = len(batch), S + 1
    ksizes = {"tile_prune": {"tiles": math.prod(shape)},
              "tile_atlas": {"corners": T * P**3, "cubes": (T * P - 1) * S * S, "tiles": T},
              "tile_global_ids": {"active": len(comp.ids), "tiles": T},
              "emit_soup_tiles": {"active": len(comp.ids), "tris": comp.n_tris, "tiles": T}}
    row = {}
    for k, (kernel, plain) in versions.items():
        base = k.replace("_param", "")
        _, ops = bounds.count_ops(plain)  # the plain version on these inputs
        nbytes = bounds.kernel_bytes(k.replace("_tiles", ""), **ksizes[base],
                                     n_params=n_params if k != base else 0)
        ms, plain_ms = in_turns(kernel, plain)
        b = bounds.bound(ops, nbytes)
        dev_ms = graph_ms(kernel)
        row[k] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, **b,
                  "share": b["bound_ms"] / ms, "graph_ms": dev_ms,
                  "device_share": dev_ms and b["bound_ms"] / dev_ms,
                  "on_device": device_reading(kernel), **ksizes[base]}
        if k != base:  # baked, parametric, parametric, baked
            row[k]["ms"], row[k]["baked_ms"] = in_turns(kernel, versions[base][0])
            row[k]["share"] = b["bound_ms"] / row[k]["ms"]
            row[k]["baked_graph_ms"] = graph_ms(versions[base][0])
    log(f"  device ms pruned {resdiv} (coarse grid {shape}, first batch {T} tiles, "
        f"{len(comp.ids)} active): "
        + ", ".join(f"{k} {v['ms']:.4f} (graph {v['graph_ms'] and round(v['graph_ms'], 4)}"
                    + (f", baked graph {v['baked_graph_ms'] and round(v['baked_graph_ms'], 4)}"
                       f", baked in turns {v['baked_ms']:.4f}" if "baked_ms" in v else "")
                    + f", on the card "
                    f"{None if v['on_device'] is None else round(v['on_device']['device_ms'], 4)}"
                    f", bound {v['bound_ms']:.4f} by {v['bound_by']}, share {v['share']:.3f} "
                    f"/ device {v['device_share'] and round(v['device_share'], 3)}, plain "
                    f"{v['plain_ms']:.3f})" for k, v in row.items())
        + f"  [{card}]")
    return row


#: the raymarcher's parts: the five that the MC phases render, and the GEB
#: sculpture of the ui-geb viewer (the benchmark's geb.view cell)
RM_PARTS = ("flange", "showerhead", "bolt", "knurled", "sphere", "geb")
#: and the random trees K8 and K8p are held to plain on
RM_FUZZ = ("fuzz0", "fuzz3", "fuzz4")
#: the path's frames at full width, (label, width, height, steps, aa): raymarch_image's
#: defaults, its rest frame at aa 3 (= the viewer's full frame), the viewer's drag
#: frame, a frame of ui(UIConfig())
RM_FRAMES = (("image aa1", 512, 512, 196, 1), ("image aa3", 512, 512, 196, 3),
             ("drag", 256, 256, 72, 1), ("ui", 800, 600, 196, 1))


def rm_geb():
    """flagships.build_geb(), built inside spans.recording(); logs its
    build's `textsdf.*` spans (spans.summary()) and textsdf.COUNTS. None
    in a checkout without it."""
    from gsdf_tpu_torch import flagships, spans

    if not hasattr(flagships, "build_geb"):
        return None
    from gsdf_tpu_torch.forge import textsdf

    spans.clear()
    t0 = time.perf_counter()
    with spans.recording():
        tree = flagships.build_geb()
    ms = (time.perf_counter() - t0) * 1e3
    text = {k: v for k, v in spans.summary().items() if k.startswith("textsdf.")}
    log(f"geb built in {ms:.3f} ms: spans {json.dumps(text)}, counters "
        f"{json.dumps(textsdf.COUNTS)}")
    spans.clear()
    return tree


def rm_args(tree, width, height, steps, aa, dev):
    """K8's arguments for one frame of `tree` at the JAX package's default view."""
    from gsdf_tpu_torch.visual import raymarch as vrm

    return (vrm.camera(tree, 0.6, 0.5, 2.4), width, height, steps, vrm.auto_relax(tree), aa,
            dev)


def rm_levels(a, b):
    """(pixels that differ, the most levels any channel differs) of two u8 images."""
    d = (a.int() - b.int()).abs().amax(-1)
    return int((d > 0).sum()), int(d.max())


#: groups of rays that run as long as their slowest ray when each thread
#: marches one ray: a 32-ray warp as 16 x 2 or 8 x 4 rays, a 128-thread
#: block of 16 x 8 rays (the layout of a one-thread-a-ray launch)
LANE_TILES = {"warp 16x2": (16, 2), "warp 8x4": (8, 4), "block 16x8": (16, 8)}


def lane_efficiency(evals, tiles=LANE_TILES) -> dict:
    """{tile: sum of evaluations / sum over tiles of (tile rays x the
    tile's most)}: the share of a group's evaluation slots that do work
    where each group of w x h neighbouring rays runs as long as its
    slowest one. evals is (rh, rw), one count a ray; rays past a ragged
    edge are idle lanes. 1.0 where no ray evaluates at all."""
    import numpy as np

    e = np.asarray(evals, np.int64)
    rh, rw = e.shape
    out = {}
    for label, (tw, th) in tiles.items():
        pad = np.zeros((-(-rh // th) * th, -(-rw // tw) * tw), np.int64)
        pad[:rh, :rw] = e
        most = pad.reshape(pad.shape[0] // th, th, pad.shape[1] // tw, tw).max(axis=(1, 3))
        slots = int(most.sum()) * tw * th
        out[label] = int(e.sum()) / slots if slots else 1.0
    return out


def ptxas_usage(text, kernel="raymarch_kernel") -> dict:
    """{"registers", "spill_stores", "spill_loads"} of the entry function
    whose name holds `kernel`, from nvcc's -Xptxas -v report."""
    import re

    usage, current = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or kernel not in current:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage["spill_stores"], usage["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage["registers"] = int(m.group(1))
    return usage


_RM_OCCUPANCY = {}


def rm_occupancy(tree, parametric, threads=128) -> int:
    """Resident blocks of `threads` threads per SM of raymarch_kernel
    (csrc/raymarch.cu around the tree's source, the parametric source with
    parametric=True), as cudaOccupancyMaxActiveBlocksPerMultiprocessor
    gives it: a small library that includes the template and asks the
    runtime, built beside the kernel's own (nvcc, the same flags)."""
    import ctypes

    from gsdf_tpu_torch import _build, kernels

    gen, _, key = kernels._sources(tree, "raymarch", parametric)
    probe = ('#include "raymarch.cu"\n'
             'extern "C" int gsdf_rm_occupancy(int threads) {\n'
             "    int n = -1;\n"
             "    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, raymarch_kernel, threads, "
             "0) != cudaSuccess) return -1;\n"
             "    return n;\n}\n")
    key = _build.source_key(key, probe)
    if key not in _RM_OCCUPANCY:
        def command(out, d):
            for name, text in {**gen, "rm_occupancy.cu": probe}.items():
                _build.write_atomic(os.path.join(d, name), text)
            return [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", d, "-I", kernels.CSRC, "-o", out,
                    os.path.join(d, "rm_occupancy.cu")]

        lib = ctypes.CDLL(_build.build_shared("rm_occupancy", key, command))
        lib.gsdf_rm_occupancy.argtypes = [ctypes.c_int]
        lib.gsdf_rm_occupancy.restype = ctypes.c_int
        _RM_OCCUPANCY[key] = lib
    n = _RM_OCCUPANCY[key].gsdf_rm_occupancy(threads)
    if n < 1:
        raise RuntimeError(f"occupancy query of raymarch_kernel failed ({n})")
    return n


def rm_lone_ray(tree, evals, dev, steps=196):
    """The longest ray's serial latency at 512 x 512 aa 1, the floor of
    any K8 design at that frame: the ray of the frame's K8 evaluation
    counts (`evals`) that evaluates most, alone, as a 1 x 1 frame whose
    camera has uu = vv = 0 and ww = r / 1.8 (r that ray's unnormalised
    direction), so that its one supersample's direction (-uu + vv) +
    1.8 ww is r again, up to the rounding of r / 1.8 * 1.8. Returns the
    ray, its evaluations and the probe's (through evals=True), and the
    probe frame's wrapper ms (events) and device ms (CUDA graph)."""
    import numpy as np
    from gsdf_tpu_torch.eval import ray_kernels as rk

    camera, w, h, _, relax, _, _ = rm_args(tree, 512, 512, steps, 1, dev)
    e = evals.cpu().numpy()
    iy, ix = (int(v) for v in np.unravel_index(int(np.argmax(e)), e.shape))
    c = rk.unpack_camera(camera)
    f = np.float32
    ux = (f(2.0) * f(ix) - f(w)) / f(h)
    uy = -(f(2.0) * f(iy) - f(h)) / f(h)
    r = (ux * c["uu"] + uy * c["vv"]) + f(1.8) * c["ww"]
    zero = np.zeros(3, f)
    lone = rk.pack_camera(c["ro"], zero, zero, r / f(1.8), c["center"], c["light"], c["scale"],
                          c["far_plane"])

    def kernel():
        return rk.raymarch(tree, lone, 1, 1, steps, relax, 1, dev)

    probe = int(rk.raymarch(tree, lone, 1, 1, steps, relax, 1, dev, evals=True)[1].item())
    return {"ray": (ix, iy), "evaluations": int(e[iy, ix]), "probe_evaluations": probe,
            "ms": cuda_ms(kernel, 20), "graph_ms": graph_ms(kernel, 20)}


def raymarch_compare(name, tree, other, dev, w=128, h=128, aa=2, steps=196):
    """K8 and K8p against raymarch_plain at w x h, aa 2, 196 steps: pixels
    and every ray's evaluation count; K8p against K8; K8p's library with a
    structurally equal tree's values (`other`) against that tree's plain
    version. Returns {form: (pixels differing, max levels)} and the
    evaluations that differ; raises unless every count is 0."""
    import torch
    from gsdf_tpu_torch.eval import ray_kernels as rk

    args, oargs = rm_args(tree, w, h, steps, aa, dev), rm_args(other, w, h, steps, aa, dev)
    img, ev = rk.raymarch(tree, *args, evals=True)
    pimg, pev = rk.raymarch(tree, *args, parametric=True, evals=True)
    oimg = rk.raymarch(other, *oargs, parametric=True)
    ref, ref_ev = rk.raymarch_plain(tree, *args, evals=True)
    oref = rk.raymarch_plain(other, *oargs)
    torch.cuda.synchronize()
    out = {"raymarch": rm_levels(img, ref), "raymarch_param": rm_levels(pimg, ref),
           "raymarch_param other values": rm_levels(oimg, oref),
           "raymarch_param vs raymarch": rm_levels(pimg, img)}
    ev_diff = int((ev != ref_ev).sum()) + int((pev != ref_ev).sum())
    log(f"  raymarch {name:12s} {w}x{h} aa {aa}: pixels differing (max levels) {out}, "
        f"evaluations differing {ev_diff}; steps per ray mean "
        f"{float(ev.float().mean()) - 5:.2f} max {int(ev.max()) - 5}")
    if ev_diff or any(n for n, _ in out.values()):
        raise RuntimeError(f"raymarch {name}: K8 / K8p differ from plain: {out}, evaluations "
                           f"{ev_diff}")
    return out


def rm_slider(tree):
    """(node, name) of the continuous parameter a slider edits: the first
    cylinder's or sphere's radius in BFS order; on a tree with neither, the
    first 3D offset's amount."""
    from gsdf_tpu_torch.eval.parametric import param_spec

    for wanted in ((("Cylinder", "r"), ("Sphere", "r")), (("Offset", "off"),)):
        for node, name, _ in param_spec(tree):
            if (type(node).__name__, name) in wanted:
                return node, name
    raise RuntimeError("no radius or offset to slide")


def rm_view_mix() -> tuple:
    """The view mix of the benchmark's viewer cell, as its traffic file
    (torch_bench/traffic/view.json) gives it: the yaw and the pitch
    strata, each (low, high, strata), and cam_dist."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_bench", "traffic",
                        "view.json")
    with open(path) as f:
        mix = json.load(f)
    draws = mix["draws"]
    return (tuple(draws["yaw"]["uniform"]) + (draws["yaw"]["strata"],),
            tuple(draws["pitch"]["uniform"]) + (draws["pitch"]["strata"],),
            mix["start"]["cam_dist"])


def rm_site_ops(tree) -> dict:
    """Each short-circuit site's skipped function's ops a point
    (bounds.tree_ops_per_point), by the site's name: the work a lane that
    skips there does not do; and each bin-table loop's member's ops, by the
    loop's name: the work of each member a lane that enters it does not
    walk."""
    import bounds
    from gsdf_tpu_torch.codegen.cuda import Codegen

    cg = Codegen()
    cg.emit(tree)
    sites, nodes, stack = list(cg.sites) + list(getattr(cg, "loops", [])), {}, [tree]
    while stack:
        node = stack.pop()
        nodes.setdefault(cg.emit(node), node)
        stack.extend(node.children())
    return {site: bounds.tree_ops_per_point(nodes[sub]) for site, sub, _ in sites}


def rm_skipped_ops(site_ops, counts) -> int:
    """The ops a counting launch's lanes did not run (ray_kernels'
    SHORT_CIRCUITS as `counts`): each site's lane skips times its skipped
    function's ops, each loop's members not walked times its member's."""
    return sum(c["lane_skips"] * site_ops[site] if "loop" not in c
               else (c["members"] * c["entries"] - c["walked"]) * site_ops[site]
               for site, c in counts.items())


def rm_short_circuits(tree, dev, w=512, h=512, steps=196, aa=3):
    """The short-circuit shares (ray_kernels.short_circuit_shares) of K8's
    counting form (ray_kernels.count_short_circuits) over the view mix's
    frames (rm_view_mix), one at the centre of each yaw x pitch stratum,
    512 x 512 aa 3 (the viewer's rest frame), and the frames'
    evaluations; per union with sites ("<union>/<member>") its sites'
    lane evaluations and warp turns summed, and their shares that skipped
    a member (a warp turn counted once a site it reached); per bin-table
    loop its counts (entries, members walked by lanes and by warp turns),
    whose members a lane entry and a warp turn are in the shares; per
    polygon's edge loop its shares of lane edge evaluations and of warp
    edge turns that divided (ray_kernels.edge_division_shares), and those
    of all its polygons together. None on a tree with no site."""
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from gsdf_tpu_torch.visual import raymarch as vrm

    if not hasattr(rk, "count_short_circuits") or not rk.sites(tree):
        return None  # (a checkout before short circuits, or no site)
    (ylo, yhi, n_yaw), (plo, phi, n_pitch), cam_dist = rm_view_mix()
    relax = vrm.auto_relax(tree)
    rk.SHORT_CIRCUITS.clear()
    edges = getattr(rk, "EDGE_DIVISIONS", None)  # None on a checkout before it
    if edges is not None:
        edges.clear()
    evaluations = 0
    for i in range(n_yaw):
        for j in range(n_pitch):
            cam = vrm.camera(tree, ylo + (i + 0.5) / n_yaw * (yhi - ylo),
                             plo + (j + 0.5) / n_pitch * (phi - plo), cam_dist)
            evaluations += int(rk.count_short_circuits(tree, cam, w, h, steps, relax, aa,
                                                       dev)[1].sum())
    counts = ("lanes", "lane_skips", "turns", "turn_skips")
    unions = {}
    for site, c in rk.SHORT_CIRCUITS.items():
        if "member" in c:
            u = unions.setdefault(site.split("/")[0], dict.fromkeys(counts, 0))
            for k in counts:
                u[k] += c[k]
    divided = None
    if edges:
        total = {k: sum(c[k] for c in edges.values())
                 for k in ("lanes", "lane_divisions", "turns", "turn_divisions")}
        divided = {"polygons": rk.edge_division_shares(), "counts": total,
                   "lane_share": total["lane_divisions"] / total["lanes"],
                   "warp_share": total["turn_divisions"] / total["turns"]}
    return {"frames": n_yaw * n_pitch, "evaluations": evaluations,
            "edge_divisions": divided,
            "shares": rk.short_circuit_shares(),
            "loops": {site: c for site, c in rk.SHORT_CIRCUITS.items() if "loop" in c},
            "unions": {name: {"lanes": u["lanes"], "turns": u["turns"],
                              "lane_share": u["lanes"] and u["lane_skips"] / u["lanes"],
                              "warp_share": u["turns"] and u["turn_skips"] / u["turns"]}
                       for name, u in unions.items()}}


def raymarch_kernel_times(parts, dev, card):
    """K8 on each part at each frame of RM_FRAMES: K8's and K8p's images
    and every ray's evaluation count against raymarch_plain's (raises
    unless all are equal), the plain call's ms (CUDA events, that one
    call), K8's and K8p's wrapper ms (CUDA events, 10 launches) and device
    ms of one call from a CUDA graph (graph_ms), the tree evaluations K8
    made (checked against plain's) with the mean and most march steps per
    ray, the bound from them (bounds.raymarch_ops; bytes: the u8 output),
    and how K8's own counts would fill groups of rays that run as long as
    their slowest one (lane_efficiency). Per part: each form's registers and spills (ptxas), its
    resident 128-thread blocks per SM (rm_occupancy) and, per frame, the
    waves a launch of one such block per 16 x 8 rays would take; at 512 x
    512 aa 1 also K8p in turns against K8 and the lone-ray probe
    (rm_lone_ray). On a part with short-circuit sites K8's counting form
    is held to plain too, and each row also gives the shares it read at
    that frame and the bound on the work K8 runs (run_bound_ms: the
    counted work less the skipped subtrahends' ops; run_device_share),
    and the part those shares over the view mix (rm_short_circuits). Returns
    ({part: {frame: row, "forms": ..., "short_circuits": ...}}, {part:
    {frame: plain's image on the host}})."""
    import torch

    import bounds
    from gsdf_tpu_torch import kernels
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from gsdf_tpu_torch.eval.parametric import kernel_params

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out, refs = {}, {}
    for name, tree in parts.items():
        forms = {}
        for form, p in (("raymarch", False), ("raymarch_param", True)):
            forms[form] = {**ptxas_usage(kernels.build_log(tree, "raymarch", p)),
                           "blocks_per_sm": rm_occupancy(tree, p), "sms": sms}
        out[name], refs[name] = {"forms": forms}, {}
        # each site's skipped ops a lane ({} on a tree with none); None on
        # a checkout before short circuits
        site_ops = rm_site_ops(tree) if hasattr(rk, "count_short_circuits") else None
        for label, w, h, steps, aa in RM_FRAMES:
            args = rm_args(tree, w, h, steps, aa, dev)
            # the program's counter of the march (None on a checkout without it)
            march = dict(rk.MARCH) if hasattr(rk, "MARCH") else None
            img, evals = rk.raymarch(tree, *args, evals=True)
            pimg, pevals = rk.raymarch(tree, *args, parametric=True, evals=True)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref, ref_evals = rk.raymarch_plain(tree, *args, evals=True)
            end.record()
            end.synchronize()
            differing = {"raymarch": rm_levels(img, ref), "raymarch_param": rm_levels(pimg, ref)}
            ev_diff = int((evals != ref_evals).sum()) + int((pevals != ref_evals).sum())
            shorts, skipped = None, 0
            if site_ops is not None:
                rk.SHORT_CIRCUITS.clear()
                cimg, cevals = rk.count_short_circuits(tree, *args)
                differing["raymarch_sites"] = rm_levels(cimg, ref)
                ev_diff += int((cevals != ref_evals).sum())
                shorts = rk.short_circuit_shares()
                skipped = rm_skipped_ops(site_ops, rk.SHORT_CIRCUITS)
                del cimg, cevals
            if ev_diff or any(n for n, _ in differing.values()):
                raise RuntimeError(f"raymarch {name} {label} ({w}x{h}, {steps} steps, aa {aa}): "
                                   f"K8 / K8p / K8's counting form differ from plain: pixels "
                                   f"(max levels) {differing}, evaluations {ev_diff}")
            refs[name][label] = ref.cpu().numpy()
            n, rays = int(evals.sum()), evals.numel()
            # MARCH's evaluations a ray over this frame's calls with evals
            march_evals = march and ((rk.MARCH["evaluations"] - march["evaluations"])
                                     / (rk.MARCH["rays"] - march["rays"]))
            host_evals = evals.cpu().numpy()
            del img, pimg, ref, pevals, ref_evals

            def kernel(args=args):
                return rk.raymarch(tree, *args)

            def param(args=args):
                return rk.raymarch(tree, *args, parametric=True)

            ms, dev_ms = cuda_ms(kernel, 10), graph_ms(kernel, 10)
            ops, nbytes = bounds.raymarch_ops(tree, n, rays), bounds.kernel_bytes("raymarch",
                                                                                   pixels=w * h)
            b = bounds.bound(ops, nbytes)
            # the bound on the work K8 runs: the counted work less each
            # skipped subtrahend's ops (its lane skips, the counting form's)
            run_ms = bounds.bound(ops - skipped, nbytes)["bound_ms"]
            tiles = -(-w * aa // 16) * -(-h * aa // 8)
            row = {"ms": ms, "graph_ms": dev_ms, "plain_ms": start.elapsed_time(end),
                   "pixels_differing_from_plain": {k: v[0] for k, v in differing.items()},
                   "evaluations_differing_from_plain": ev_diff, "evaluations": n, "rays": rays,
                   "mean_steps": n / rays - 5, "max_steps": int(host_evals.max()) - 5,
                   "march_evals": march_evals,
                   # the queue counter's memset, K8, and the box filter at aa > 1
                   "launches_per_call": {"memsets": 1, "kernels": 1 + (aa > 1)},
                   "library_ms": None, **b,
                   "share": b["bound_ms"] / ms, "device_share": dev_ms and b["bound_ms"] / dev_ms,
                   "lanes": lane_efficiency(host_evals),
                   "tile_waves": {form: tiles / (v["blocks_per_sm"] * sms)
                                  for form, v in forms.items()},
                   "param_ms": cuda_ms(param, 10), "param_graph_ms": graph_ms(param, 10),
                   "short_circuits": shorts, "run_bound_ms": run_ms,
                   "run_device_share": dev_ms and run_ms / dev_ms}
            row["param_device_share"] = row["param_graph_ms"] and (
                b["bound_ms"] / row["param_graph_ms"])
            if label.startswith("image"):
                # what the card runs inside one wrapper call: a trace can miss
                # a call's device events, never add one
                row["on_device"] = device_reading(kernel)
                seen = row["on_device"] or {}
                if any(seen.get(k, 0) > n for k, n in row["launches_per_call"].items()):
                    raise RuntimeError(f"raymarch {name} {label}: the card ran {seen}, more than "
                                       f"{row['launches_per_call']}")
            if label == "image aa1":
                row["param_ms"], row["baked_ms"] = in_turns(param, kernel)
                row["param_bytes"] = bounds.kernel_bytes(
                    "raymarch_param", pixels=w * h, n_params=int(kernel_params(tree).size))
                row["lone_ray"] = rm_lone_ray(tree, evals, dev, steps)
            out[name][label] = row
            del evals
            torch.cuda.empty_cache()
        out[name]["short_circuits"] = rm_short_circuits(tree, dev)
        log(f"  device ms raymarch {name}, K8 and K8p equal to plain in every pixel and "
            f"evaluation at every frame; forms {json.dumps(forms)}: "
            + ", ".join(f"{k} {v['ms']:.4f} (graph {v['graph_ms'] and round(v['graph_ms'], 4)}, "
                        f"bound {v['bound_ms']:.4f} by {v['bound_by']}, device share "
                        f"{v['device_share'] and round(v['device_share'], 3)}, on the work run "
                        f"{v['run_bound_ms']:.4f}, "
                        f"{v['run_device_share'] and round(v['run_device_share'], 3)}, "
                        f"steps per ray mean "
                        f"{v['mean_steps']:.2f} max {v['max_steps']}, MARCH evaluations a ray "
                        f"{v['march_evals']}, plain {v['plain_ms']:.3f}, "
                        f"K8p {v['param_ms']:.4f} graph "
                        f"{v['param_graph_ms'] and round(v['param_graph_ms'], 4)}, lanes "
                        + json.dumps({x: round(y, 3) for x, y in v["lanes"].items()})
                        + f", 16x8 tile waves {json.dumps(v['tile_waves'])}"
                        + f", short circuits {json.dumps(v['short_circuits'])}"
                        + (f", K8p / K8 in turns {v['param_ms']:.4f} / {v['baked_ms']:.4f}, "
                           f"lone ray {json.dumps(v['lone_ray'])}" if "baked_ms" in v else "")
                        + ")"
                        for k, v in out[name].items() if k not in ("forms", "short_circuits"))
            + f"; short circuits over the view mix {json.dumps(out[name]['short_circuits'])}"
            + f"  [{card}]")
    return out, refs


def raymarch_study(dev, card) -> int:
    """`chip_smoke.py --raymarch`: only the raymarcher's kernel rows
    (raymarch_kernel_times) on the five parts, their libraries and
    occupancy probes built in parallel first, as one JSON line. Runs
    against whichever gsdf_tpu_torch the script's folder holds, so that a
    copy of it beside an older checkout measures that checkout's K8."""
    from gsdf_tpu_torch import Builder, flagships, kernels
    from gsdf_tpu_torch.eval import grid_kernels as gk
    from gsdf_tpu_torch.eval import ray_kernels as rk

    parts = {name: getattr(flagships, f"build_{name}")() for name in RM_PARTS[:4]}
    parts["sphere"] = Builder().new_sphere(1.0)
    geb = rm_geb()
    if geb is not None:
        parts["geb"] = geb
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=32) as pool:
        futs = [pool.submit(kernels.build, tree, "raymarch", p)
                for tree in parts.values() for p in (False, True)]
        futs += [pool.submit(rm_occupancy, tree, p) for tree in parts.values() for p in (False, True)]
        for fut in futs:
            fut.result()
    log(f"raymarch study: {len(futs)} libraries in {time.perf_counter() - t0:.1f} s")
    times, _ = raymarch_kernel_times(parts, dev, card)
    log(json.dumps({"raymarch_kernels": times}))
    log(card)
    return 0


def raymarch_paths(parts, refs, dev, card, run, exactly):
    """The raymarcher's main path at full width on each part, through the
    entry points a user calls, on the default device (the card): every
    launch count at 0 just before each path and read just after, launches
    per frame exact and recorded as counted, one synchronising call per
    frame (the fetch). `refs` is raymarch_kernel_times' plain images at
    the default view ({part: {RM_FRAMES label: image}}).
    - raymarch_image(part) with the JAX package's defaults (512 x 512, 196
      steps, auto_relax, aa 1), and with aa 3: host-clock ms per frame, the
      image equal to plain's;
    - InteractiveViewer(part) driven by on_press / on_move / on_scroll /
      on_release (drag frames 256 x 256 at 72 steps, full frames 512 x 512
      at 196 steps and aa 3), drag and full frames counted apart: no build
      after the first frame, whose image equals plain's; frame ms split
      into K8 (graph_ms), fetch and host (the drag frame's np.repeat); the
      pipelined drag frames against the synchronous ones;
    - ui(part, UIConfig()): 24 frames at 800 x 600 and the GIF, read back;
    - InteractiveViewer(part, params=[...]) with set_param: K8p only, no
      build and no library loaded after the first frame, each edited
      frame (512 x 512, aa 3) equal to the edited tree's plain version.
    Returns ({part: results}, {path: launches per frame})."""
    import statistics
    import tempfile

    import numpy as np
    import torch
    from PIL import Image
    from gsdf_tpu_torch import _build, pipeline
    from gsdf_tpu_torch.eval import ray_kernels as rk
    from gsdf_tpu_torch.visual import raymarch as vrm

    results, per_frame = {}, {}

    def counted_frames(path, counts, frames):
        """Record the launches per frame of `path`, as counted; the same on
        every part."""
        got = {k: n / frames for k, n in counts.items() if n}
        if per_frame.setdefault(path, got) != got:
            raise RuntimeError(f"{path}: launches per frame {got}, {per_frame[path]} before")

    def same_as_plain(label, img, ref):
        if not np.array_equal(img, ref):
            raise RuntimeError(f"{label}: {int((img != ref).any(-1).sum())} pixels differ from "
                               "raymarch_plain's")

    def median_ms(fn, reps=3):
        ms = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms[1:])  # the first is a warm-up

    def split(v, quality, reps=3):
        """(K8 graph ms, fetch ms, host ms) of one viewer frame."""
        k8 = graph_ms(lambda: v._dispatch(quality), 5)
        fetch, host = [], []
        for _ in range(reps):
            frame = v._dispatch(quality)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = frame.cpu().numpy()
            t1 = time.perf_counter()
            if quality == "drag":
                np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)
            t2 = time.perf_counter()
            fetch.append((t1 - t0) * 1e3)
            host.append((t2 - t1) * 1e3)
        return k8, statistics.median(fetch), statistics.median(host)

    for name, tree in parts.items():
        row = {}
        for aa in (1, 3):
            label = f"raymarch_image {name} aa {aa}"
            ms, counts = run(label, ("raymarch",), lambda: median_ms(
                lambda: vrm.raymarch_image(tree, aa=aa)))
            exactly(label, counts, {"raymarch": 4})
            counted_frames(f"raymarch_image aa{aa}", counts, 4)  # a warm-up and 3
            img, syncs = synchronising(lambda: vrm.raymarch_image(tree, aa=aa))
            if len(syncs) != 1:
                raise RuntimeError(f"{label}: {len(syncs)} synchronising calls, not 1: {syncs}")
            if img.shape != (512, 512, 3) or img.dtype != np.uint8 or len(
                    np.unique(img.reshape(-1, 3), axis=0)) < 100:
                raise RuntimeError(f"{label}: not a shaded 512 x 512 image")
            same_as_plain(label, img, refs[name][f"image aa{aa}"])
            row[f"raymarch_image aa{aa} ms"] = ms

        v = pipeline.InteractiveViewer(tree)  # no device named: the card
        if v.device != dev:
            raise RuntimeError(f"InteractiveViewer defaulted to {v.device}, not the card")
        first_img, counts = run(f"viewer {name} first frame", ("raymarch",),
                                lambda: v.render_current("full"))  # builds or loads
        exactly(f"viewer {name} first frame", counts, {"raymarch": 1})
        same_as_plain(f"viewer {name} first frame", first_img, refs[name]["image aa3"])
        first = dict(_build.COUNTS)

        def drags(v=v):
            v.on_press(256, 256)
            for x in (270, 290, 310, 330):
                v.on_move(x, 262)
                v.render_current("drag")
            v.on_release()
            v.on_scroll(1)
            v.render_current("drag")

        def fulls(v=v):
            for _ in range(3):
                v.render_current("full")
                v.on_scroll(-1)

        _, counts = run(f"viewer {name} drag frames", ("raymarch",), drags)
        exactly(f"viewer {name} drag frames", counts, {"raymarch": 5})
        counted_frames("viewer drag", counts, 5)
        _, counts = run(f"viewer {name} full frames", ("raymarch",), fulls)
        exactly(f"viewer {name} full frames", counts, {"raymarch": 3})
        counted_frames("viewer full", counts, 3)
        if dict(_build.COUNTS) != first:
            raise RuntimeError(f"viewer {name}: built after the first frame")
        stats = v.frame_stats()
        _, drag_syncs = synchronising(lambda: v.render_current("drag"))
        _, full_syncs = synchronising(lambda: v.render_current("full"))
        if len(drag_syncs) != 1 or len(full_syncs) != 1:
            raise RuntimeError(f"viewer {name}: synchronising calls a frame {drag_syncs} / "
                               f"{full_syncs}, not 1")
        row["viewer"] = {q: {"frames": s["frames"], "median_ms": s["median_ms"]}
                         for q, s in stats.items()}
        row["split drag (K8 graph, fetch, host)"] = split(v, "drag")
        row["split full (K8 graph, fetch, host)"] = split(v, "full")
        pipe = pipeline.InteractiveViewer(tree, pipeline=True)
        sync_v = pipeline.InteractiveViewer(tree)
        for viewer in (pipe, sync_v):
            viewer.on_press(256, 256)
        turns = {"pipelined": [], "synchronous": []}
        for k in range(12):
            for key, viewer in (("synchronous", sync_v), ("pipelined", pipe)):
                viewer.on_move(256 + 3 * k, 258)
                t0 = time.perf_counter()
                viewer.render_current("drag")
                turns[key].append((time.perf_counter() - t0) * 1e3)
        row["drag ms pipelined / synchronous"] = (statistics.median(turns["pipelined"][2:]),
                                                  statistics.median(turns["synchronous"][2:]))

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "turntable.gif")
            t0 = time.perf_counter()
            frames, counts = run(f"ui {name}", ("raymarch",),
                                 lambda: pipeline.ui(tree, pipeline.UIConfig(gif_path=path)))
            ui_ms = (time.perf_counter() - t0) * 1e3
            exactly(f"ui {name}", counts, {"raymarch": 24})
            counted_frames("ui frame", counts, len(frames))
            # Pillow writes a frame equal to the one before it as one frame
            distinct = 1 + sum(not np.array_equal(a, b) for a, b in zip(frames, frames[1:]))
            with Image.open(path) as gif:
                if len(frames) != 24 or frames[0].shape != (600, 800, 3) or (
                        gif.n_frames != distinct):
                    raise RuntimeError(f"ui {name}: {len(frames)} frames, GIF of "
                                       f"{gif.n_frames}, {distinct} distinct")
        row["ui ms (24 frames + GIF)"] = ui_ms

        node, pname = rm_slider(tree)
        value = float(getattr(node, pname))
        pv = pipeline.InteractiveViewer(tree, params=[(pname, node, pname, 0.5 * value,
                                                       1.5 * value)])
        first_img, counts = run(f"viewer set_param {name} first frame", ("raymarch_param",),
                                lambda: pv.render_current("full"))  # builds or loads
        exactly(f"viewer set_param {name} first frame", counts, {"raymarch_param": 1})
        same_as_plain(f"viewer set_param {name} first frame", first_img, refs[name]["image aa3"])
        first = dict(_build.COUNTS)

        def edits(pv=pv, node=node, pname=pname, value=value):
            imgs, edit_ms = [], []
            for f in (1.02, 0.98, 1.0):
                pv.set_param(node, pname, value * f)
                t0 = time.perf_counter()
                imgs.append(pv.render_current("full"))
                edit_ms.append((time.perf_counter() - t0) * 1e3)
            pv.on_press(256, 256)
            pv.on_move(280, 262)
            pv.render_current("drag")
            pv.render_current("drag")
            return imgs, edit_ms

        (imgs, edit_ms), counts = run(f"viewer set_param {name}", ("raymarch_param",), edits)
        exactly(f"viewer set_param {name}", counts, {"raymarch_param": 5})
        counted_frames("viewer set_param", counts, 5)
        if dict(_build.COUNTS) != first:
            raise RuntimeError(f"viewer set_param {name}: built after the first frame")
        # each edited frame against the edited tree's plain version at the
        # viewer's own full frame (the camera frames the edited bounds);
        # the last edit restores the value
        for f, img in zip((1.02, 0.98), imgs):
            pv.set_param(node, pname, value * f)
            full_args = rm_args(pv.obj, pv.width, pv.height, pv.steps, pv.aa, dev)
            same_as_plain(f"viewer set_param {name} {pname} x {f}", img,
                          rk.raymarch_plain(pv.obj, *full_args).cpu().numpy())
        pv.set_param(node, pname, value)
        same_as_plain(f"viewer set_param {name} restored", imgs[-1], refs[name]["image aa3"])
        row["set_param"] = {"param": f"{type(node).__name__}.{pname}",
                            "edit_to_frame_ms": edit_ms,
                            "edit visible": not np.array_equal(imgs[0], first_img)}
        results[name] = row
        log(f"phase 3: raymarch {name}: {json.dumps(row)}  [{card}]")
    return results, per_frame


def dc_compare(label, tree, res, dev, slab=None, chiseled=False, grid=None):
    """K5 and K5p through their wrapper (dc_emit.dc_mesh) against
    dc_mesh_plain on the card: edge ids, flips and the live-voxel count
    exact, vertices within DC_TOL * res; K5's grid (from a call of its own)
    equal to K2's. On a whole grid, also K5's edge form (dc_emit.dc_edges,
    what the host_qef=True render reads) against dc_edges_plain: edge ids,
    flips, t and the raw normals all exact. slab = (k0, owned layers) runs
    a slab of the grid with its halo; grid = (origin, corner shape) names
    the grid instead of DualContourRenderer(tree, res). Returns ({kernel:
    (max |d|, max |d| / res, grid floats differing from K2)}, edges,
    voxels, dc_edges floats differing from plain or None on a slab)."""
    import numpy as np
    import torch
    from gsdf_tpu_torch.eval import grid_kernels as gk
    from gsdf_tpu_torch.ops import dc_emit
    from gsdf_tpu_torch.render.dual_contour import DualContourLeastSquares, DualContourRenderer

    c = DualContourLeastSquares(chiseled)
    if grid is None:
        dcr = DualContourRenderer(tree, res, c, device=dev)
        origin, shape, res = dcr.origin, dcr.shape(), dcr.res
    else:
        (origin, shape), res = grid, np.float32(res)
    k0, n_own = slab or (0, None)
    if slab is not None:
        shape = (n_own + 2,) + tuple(shape[1:])
    ref = dc_emit.dc_mesh_plain(tree, origin, res, shape, dev, c.norm_step, c.sqrt_lambda, k0,
                                n_own)
    k2 = gk.evaluate_grid(tree, origin, res, shape, dev, k0)
    out = {}
    for name, parametric in (("dc_mesh", False), ("dc_mesh_param", True)):
        mesh = dc_emit.dc_mesh(tree, origin, res, shape, dev, c.norm_step, c.sqrt_lambda, k0,
                               n_own, parametric)
        grid = dc_emit._launch_k5(tree, origin, res, shape, dev, n_own, k0, parametric,
                                  *dc_emit.qef_constants(c.norm_step, c.sqrt_lambda), False,
                                  True)[-1]
        torch.cuda.synchronize()
        if not (torch.equal(mesh.eids, ref.eids) and torch.equal(mesh.flips, ref.flips)
                and mesh.verts.shape == ref.verts.shape):
            raise RuntimeError(f"{name} {label}: edge ids, flips or the live-voxel count differ "
                               f"from plain ({len(mesh.eids)} / {len(ref.eids)} edges, "
                               f"{len(mesh.verts)} / {len(ref.verts)} voxels)")
        err = _max_abs(mesh.verts, ref.verts)
        differing = int((grid != k2).sum())
        if err > DC_TOL * float(res) or differing:
            raise RuntimeError(f"{name} {label}: vertices {err / float(res):.3g} * res from "
                               f"plain, {differing} grid floats differ from K2's")
        out[name] = (err, err / float(res), differing)
    edges_differing = None
    if slab is None:
        e = dc_emit.dc_edges(tree, origin, res, shape, dev, c.norm_step)
        e_ref = dc_emit.dc_edges_plain(tree, origin, res, shape, dev, c.norm_step)
        torch.cuda.synchronize()
        if not (torch.equal(e.eids, e_ref.eids) and torch.equal(e.flips, e_ref.flips)):
            raise RuntimeError(f"dc_edges {label}: edge ids or flips differ from plain "
                               f"({len(e.eids)} / {len(e_ref.eids)} edges)")
        edges_differing = int((e.t != e_ref.t).sum()) + int((e.normals != e_ref.normals).sum())
        if edges_differing:
            raise RuntimeError(f"dc_edges {label}: {edges_differing} floats of t and the normals "
                               "differ from plain")
    log(f"  K5, K5p {label:22s} {'chiseled' if chiseled else 'default '}: {len(ref.eids)} "
        f"edges, {len(ref.verts)} voxels exact; max |d| / res {out['dc_mesh'][1]:.3g}, "
        f"{out['dc_mesh_param'][1]:.3g}; grid floats differing from K2 {out['dc_mesh'][2]}, "
        f"{out['dc_mesh_param'][2]}; dc_edges: ids, flips exact, t and normal floats "
        f"differing {'(a slab: not run)' if edges_differing is None else edges_differing}")
    return out, len(ref.eids), len(ref.verts), edges_differing


#: what one K5 call runs on the card: eval, flags, scan, edges, normals,
#: QEF (its work words are zeroed by the eval pass: no memset)
DC_KERNELS_PER_CALL = 6


def dc_on_card(label, call):
    """The kernels, memsets and copies (the count read) that torch.profiler
    sees on the card inside one K5 call; fails where it sees more kernels
    than DC_KERNELS_PER_CALL or any memset (a trace can miss events, never
    add any). None where every trace missed the call."""
    reading = device_reading(call)
    if reading is None:
        return None
    seen = {k: reading[k] for k in ("kernels", "memsets", "copies")}
    if seen["kernels"] > DC_KERNELS_PER_CALL or seen["memsets"]:
        raise RuntimeError(f"{label}: a K5 call ran {seen} on the card, expected at most "
                           f"{DC_KERNELS_PER_CALL} kernels and no memset")
    return seen


def dc_word_grid(tree, nx):
    """(res, (origin, corner shape)) of a grid of exactly nx voxels a row
    around the tree (cubic voxels; ny and nz follow from its bounds), so
    that K5 meets the row, word and plane ends that a given nx makes."""
    import numpy as np

    bb = tree.bounds()
    lo, size = np.asarray(bb.min, np.float32), np.asarray(bb.size(), np.float32)
    res = np.float32(size[0] / (nx - 0.5))
    ny, nz = (int(math.ceil(size[a] / res + 0.5)) for a in (1, 2))
    return res, (lo - res / 4, (nz + 1, ny + 1, nx + 1))


def dc_grid_cases(tree):
    """K5's explicit small grids: rows of DC_WORD_NX voxels (below, at and
    one past a word, and 2 + 64), one as a slab with k0 > 0 and fewer
    owned layers than it has, as (label, res, slab, grid) for dc_compare."""
    cases = []
    for nx in DC_WORD_NX:
        res, grid = dc_word_grid(tree, nx)
        cases.append((f"nx={nx} {grid[1]}", res, None, grid))
    res, grid = dc_word_grid(tree, 33)
    k0 = grid[1][0] // 2
    cases.append((f"nx=33 slab k0={k0}, 3 of 4 layers owned", res, (k0, 3), grid))
    return cases


def dc_pass_bounds(name, corners, words, edges, voxels, tree_ops, total_ops, ranked=False):
    """The bound of one K5 pass, by its kernel's name (bounds.bound): ops
    for the tree passes and the QEF, bytes for the integer passes, each
    input read once and each output written once. corners, words (32-voxel
    words per axis), edges and voxels from this run; tree_ops per point;
    total_ops the plain version's on the same grid (bounds.count_ops),
    whose remainder after the tree's and the normals' work is the QEF's
    (with the few ops of t and the crossing points). ranked: the flag pass
    also writes the edge ranks (the earlier design, with a live pass)."""
    import bounds

    eval_ops = tree_ops * corners
    normal_ops = 6 * edges * tree_ops + 24 * edges  # 18 offsets, 3 differences, 3 scales
    table = {
        "eval": (eval_ops, 4 * corners),
        "flag": (0, 4 * corners + (24 if ranked else 12) * words),  # distances in, words out
        "live": (0, 12 * words + 4 * voxels),  # the earlier live pass: words in, ids out
        "scan": (0, 24 * words + 4 * voxels),  # ballot words in, ranks and live ids out
        "edge": (0, 24 * words + 8 * edges + 17 * edges),  # words, ranks, two ends; id, flip, point
        "normal": (normal_ops, 24 * edges),
        "qef": (total_ops - eval_ops - normal_ops, 12 * voxels),
    }
    for key, (ops, nbytes) in table.items():
        if key in name.lower():
            return bounds.bound(ops, nbytes)
    return None


_DC_OCCUPANCY = {}


def dc_occupancy(tree, parametric) -> dict:
    """{kernel: {"registers", "threads", "blocks_per_sm", "local_bytes"}}
    of every __global__ function of the checkout's csrc/dc_mesh.cu around
    the tree's source (the parametric source with parametric=True), as
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    give them at the block size of its __launch_bounds__: a small library
    that includes the template, built beside K5 (nvcc, the same flags)."""
    import ctypes
    import re

    from gsdf_tpu_torch import _build, kernels

    with open(os.path.join(kernels.CSRC, "dc_mesh.cu")) as f:
        names = re.findall(r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s+(\w+)\s*\(", f.read())
    gen, _, key = kernels._sources(tree, "dc", parametric)
    probe = ('#include "dc_mesh.cu"\n'
             "template <typename F> static int occupancy(F f, int* out) {\n"
             "    cudaFuncAttributes a;\n"
             "    if (cudaFuncGetAttributes(&a, f) != cudaSuccess) return 1;\n"
             "    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, f, "
             "a.maxThreadsPerBlock, 0) != cudaSuccess) return 1;\n"
             "    out[0] = a.numRegs; out[1] = a.maxThreadsPerBlock;\n"
             "    out[3] = (int)a.localSizeBytes;\n"
             "    return 0;\n}\n"
             'extern "C" int gsdf_dc_occupancy(int* out) {\n    int rc = 0;\n'
             + "".join(f"    rc |= occupancy({n}, out + {4 * i});\n" for i, n in enumerate(names))
             + "    return rc;\n}\n")
    key = _build.source_key(key, probe)
    if key not in _DC_OCCUPANCY:
        def command(out, d):
            for name, text in {**gen, "dc_occupancy.cu": probe}.items():
                _build.write_atomic(os.path.join(d, name), text)
            return [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", d, "-I", kernels.CSRC, "-o", out,
                    os.path.join(d, "dc_occupancy.cu")]

        lib = ctypes.CDLL(_build.build_shared("dc_occupancy", key, command))
        lib.gsdf_dc_occupancy.argtypes = [ctypes.c_void_p]
        lib.gsdf_dc_occupancy.restype = ctypes.c_int
        _DC_OCCUPANCY[key] = lib
    out = (ctypes.c_int * (4 * len(names)))()
    if _DC_OCCUPANCY[key].gsdf_dc_occupancy(out):
        raise RuntimeError("occupancy query of K5's kernels failed")
    return {n: dict(zip(("registers", "threads", "blocks_per_sm", "local_bytes"),
                        out[4 * i:4 * i + 4])) for i, n in enumerate(names)}


def dc_wall_split(dcr, parametric, reps=7):
    """One DualContourRenderer's K5 stage, split: per K5 call (one a chunk)
    the host's work before the first launch, the count passes (device ms,
    CUDA events around the first C call), the gap at the count read (host
    clock from the first C call's return to the second's start: the wait
    for the counts, the read, the outputs' allocation), the emit (the
    second C call to the wrapper's return on the host, and its passes'
    device ms), then the fetch. Through render/dual_contour.mesh_chunks,
    as a render runs it: kernels.launch is wrapped for the run to time each
    C call. Median over reps after two warm-ups; each part summed over the
    calls of a render."""
    import statistics

    import torch
    from gsdf_tpu_torch import kernels
    from gsdf_tpu_torch.render import dual_contour

    real = kernels.launch
    chunks, space = dcr.chunks()
    runs = []
    for _ in range(reps + 2):
        marks, laps = [], [("start", time.perf_counter())]

        def timed(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            real(*args, **kw)
            ev[1].record()
            marks.append((t0, time.perf_counter(), ev))

        kernels.launch = timed
        try:
            dual_contour.mesh_chunks(dcr.s, dcr.res, dcr.contourer, dcr.device, parametric,
                                     chunks, space, lambda s: laps.append((s, time.perf_counter())))
        finally:
            kernels.launch = real
        torch.cuda.synchronize()
        if len(marks) != 2 * len(chunks):
            raise RuntimeError(f"expected two C calls a K5 call, saw {len(marks)}")
        part = {"host before launch": 0.0, "count passes (device)": 0.0,
                "gap at count read": 0.0, "emit host": 0.0, "emit (device)": 0.0, "fetch": 0.0}
        for c in range(len(chunks)):
            (a0, a1, ea), (b0, _, eb) = marks[2 * c], marks[2 * c + 1]
            start, k5, fetched = laps[2 * c][1], laps[2 * c + 1][1], laps[2 * c + 2][1]
            part["host before launch"] += (a0 - start) * 1e3
            part["count passes (device)"] += ea[0].elapsed_time(ea[1])
            part["gap at count read"] += (b0 - a1) * 1e3
            part["emit host"] += (k5 - b0) * 1e3
            part["emit (device)"] += eb[0].elapsed_time(eb[1])
            part["fetch"] += (fetched - k5) * 1e3
        runs.append(part)
    return {k: statistics.median(r[k] for r in runs[2:]) for k in runs[0]}


def dc_sdf_to_stl_ms(dcr, parametric, reps=7) -> dict:
    """The DC render's SDF->STL wall ms as a user runs it: a new
    DualContourRenderer like dcr, render(), its binary STL in memory; host
    clock from a synchronised start to the STL's last byte, `reps` runs
    after two warm-ups, and their median."""
    import io
    import statistics

    import torch
    from gsdf_tpu_torch import render
    from gsdf_tpu_torch.render.dual_contour import DualContourRenderer

    runs = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = io.BytesIO()
        render.write_binary_stl(buf, DualContourRenderer(dcr.s, dcr.res, dcr.contourer,
                                                         dcr.device).render(parametric))
        runs.append(round((time.perf_counter() - t0) * 1e3, 3))
    return {"median": statistics.median(runs[2:]), "runs": runs[2:]}


def dc_digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order: two runs' outputs equal bit
    for bit where their digests are."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def dc_study(dev, card) -> int:
    """`chip_smoke.py --dc`: only the dual contouring kernel rows. Builds
    the bolt's K5 and K5p and their occupancy probes (dc_occupancy) in
    parallel; holds K5 and K5p against plain on the explicit small grids
    (dc_grid_cases) and on the bolt at resdiv 256 (dc_compare); then for
    each K5 call of the bolt's renders at resdiv 256, 384 and 512 (one a
    chunk there), K5 and K5p: the wrapper's ms (CUDA events, mean of 20
    calls) and the plain version's, the device us of each pass
    (torch.profiler, stages.device_us) beside its bound (dc_pass_bounds),
    the digests of its outputs (edge ids, flips, vertices; dc_edges' t and
    normals on the whole grids; the render's triangles), the K5 stage's
    wall split (dc_wall_split) and the render's SDF->STL ms
    (dc_sdf_to_stl_ms); each pass's registers, block size and resident
    blocks per SM. Runs against whichever gsdf_tpu_torch the script's
    folder holds, so that a copy of it beside an older checkout measures
    that checkout's K5. Prints one JSON line, the card, and the contract's
    last line."""
    import torch

    import bounds
    from gsdf_tpu_torch import flagships, kernels, stages
    from gsdf_tpu_torch.ops import dc_emit
    from gsdf_tpu_torch.render.dual_contour import DualContourRenderer

    bolt = flagships.build_bolt()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(kernels.build, bolt, "dc", p) for p in (False, True)]
        futs.append(pool.submit(kernels.build, bolt))  # K2, which K5's grid is held to
        occ = {p: pool.submit(dc_occupancy, bolt, p) for p in (False, True)}
        for fut in futs:
            fut.result()
        occ = {("K5p" if p else "K5"): f.result() for p, f in occ.items()}
    log(f"dc study: 5 libraries in {time.perf_counter() - t0:.1f} s")
    for form, p in (("K5", False), ("K5p", True)):
        text = kernels.build_log(bolt, "dc", p)
        for kernel, row in occ[form].items():
            row.update({k: v for k, v in ptxas_usage(text, kernel).items() if k != "registers"})
        log(f"  {form} per pass (registers, threads a block, blocks per SM, spills): "
            f"{json.dumps(occ[form])}  [{card}]")
    checked = 0
    for label, res, slab, grid in dc_grid_cases(bolt) + [("bolt@256", None, None, None)]:
        if res is None:
            res = bolt.bounds().diagonal() / 256
        for chiseled in (False, True):
            _, n_e, n_v, _ = dc_compare(label, bolt, res, dev, slab, chiseled, grid)
            if n_e == 0 or n_v == 0:
                raise RuntimeError(f"K5 {label}: nothing to compare")
            checked += 1
    log(f"dc study: K5 and K5p equal to plain on {checked} grids and modes")
    tree_ops = bounds.tree_ops_per_point(bolt)
    out = {"card": card, "occupancy": occ, "tree_ops": tree_ops, "renders": {}}
    for resdiv in (256, 384, 512):
        dcr = DualContourRenderer(bolt, bolt.bounds().diagonal() / resdiv, device=dev)
        cont = dcr.contourer
        calls, _ = dcr.chunks()
        row = {"calls": []}
        for n, (origin, shape, k0, n_own) in enumerate(calls):
            args = (bolt, origin, dcr.res, shape, dev, cont.norm_step, cont.sqrt_lambda, k0, n_own)
            mesh, ops = bounds.count_ops(lambda: dc_emit.dc_mesh_plain(*args))
            nk, nj, ni = shape
            sizes = {"corners": nk * nj * ni, "words": -(-(nk - 1) * (nj - 1) * (ni - 1) // 32),
                     "edges": len(mesh.eids), "voxels": len(mesh.verts)}
            del mesh
            call = {"shape": list(shape), "k0": k0, "n_own": n_own, **sizes,
                    "plain_ms": cuda_ms(lambda: dc_emit.dc_mesh_plain(*args), 2)}
            for form, p in (("K5", False), ("K5p", True)):
                m = dc_emit.dc_mesh(*args, parametric=p)
                call[f"{form} digest"] = dc_digest(m.eids, m.flips, m.verts)
                call[f"{form} ms"] = cuda_ms(lambda p=p: dc_emit.dc_mesh(*args, parametric=p), 20)
                us = stages.device_us(lambda p=p: dc_emit.dc_mesh(*args, parametric=p))
                passes = {}
                for kernel, t in us.items():
                    b = dc_pass_bounds(kernel, **sizes, tree_ops=tree_ops, total_ops=ops,
                                       ranked=any("live" in k for k in us))
                    passes[kernel] = {"us": t, **({"bound_us": b["bound_ms"] * 1e3,
                                                   "bound_by": b["bound_by"]} if b else {})}
                total = sum(v["us"] for v in passes.values())
                call[form] = {"passes": passes, "total_us": total,
                              "bound_us": bounds.bound(ops, bounds.kernel_bytes(
                                  "dc_mesh", edges=sizes["edges"],
                                  voxels=sizes["voxels"]))["bound_ms"] * 1e3}
                log(f"  {form} bolt@{resdiv} call {n} {tuple(shape)} k0={k0}: {sizes['edges']} "
                    f"edges, {sizes['voxels']} voxels; device us by pass "
                    + ", ".join(f"{k} {v['us']:.1f}"
                                + (f" (bound {v['bound_us']:.1f} by {v['bound_by']})"
                                   if "bound_us" in v else "") for k, v in passes.items())
                    + f"; total {total:.1f}, K5's bound {call[form]['bound_us']:.1f}; wrapper "
                    f"{call[f'{form} ms']:.4f} ms (events), plain {call['plain_ms']:.3f} ms  "
                    f"[{card}]")
            if k0 == 0 and n_own is None:
                e = dc_emit.dc_edges(bolt, origin, dcr.res, shape, dev, cont.norm_step)
                call["dc_edges digest"] = dc_digest(e.eids, e.flips, e.t, e.normals)
            row["calls"].append(call)
            torch.cuda.empty_cache()
        for form, p in (("K5", False), ("K5p", True)):
            row[f"{form} render digest"] = dc_digest(torch.from_numpy(dcr.render(parametric=p)))
            row[f"{form} wall split ms"] = split = dc_wall_split(dcr, p)
            row[f"{form} SDF->STL ms"] = stl_ms = dc_sdf_to_stl_ms(dcr, p)
            log(f"  {form} bolt@{resdiv} K5 stage over {len(calls)} call(s), ms: "
                + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + f"; SDF->STL median {stl_ms['median']:.3f} ms (runs {stl_ms['runs']})  [{card}]")
        out["renders"][f"bolt@{resdiv}"] = row
    log(json.dumps({"dc_kernels": out}))
    finish(card)
    return 0


def finish(card) -> None:
    """The contract's last two lines: the card, then the result."""
    import torch

    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


def device_launches(fn) -> dict:
    """What torch.profiler sees on the card inside one call of fn: kernels,
    memsets and copies by count, and their device time summed (ms): the
    call's time with the host's share taken out. Every fn given here
    launches a kernel, and the profiler now and then returns a trace that
    holds the host's launch calls and no device event (about 1 in 500 on
    an idle host, several in a row on a busy one), so a trace without a
    kernel is taken again, after a growing pause, at most twelve times
    before it counts as a fault. The device events are read by their
    category in the trace (kernel, memset, copy), as torch_bench/trace.py
    reads them: a profiler may also put a synchronisation on the device's
    timeline, which is none of the call's work."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    kinds = {"kernel": "kernels", "gpu_memset": "memsets", "gpu_memcpy": "copies"}
    for attempt in range(12):
        time.sleep(0.1 * attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        out = {"kernels": 0, "memsets": 0, "copies": 0, "device_ms": 0.0}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in kinds:
                out[kinds[e["cat"]]] += 1
                out["device_ms"] += float(e.get("dur", 0)) / 1e3
        if out["kernels"]:
            return out
    raise RuntimeError("torch.profiler saw no kernel inside a wrapper call in twelve traces")


def device_reading(fn):
    """device_launches(fn) where it is a measurement and not a check: None,
    logged, where every trace missed the call's kernels, and the run goes
    on."""
    try:
        return device_launches(fn)
    except RuntimeError as e:
        log(f"  device reading: {e}")
        return None


def on_card_ms(a, b, turns: int = 3):
    """The device ms that torch.profiler sums inside one call of a and of
    b, taken in turns (a, b, a, b, ...): the two with the host's share
    taken out. A trace can miss some of a call's device events (seen on
    launches that take their parameters by value), never add any, so each
    is the most of its traces; None where every trace missed them all."""
    def traced(fn):
        reading = device_reading(fn)
        return None if reading is None else reading["device_ms"]

    pairs = [(traced(a), traced(b)) for _ in range(turns)]
    return tuple(max((p[k] for p in pairs if p[k] is not None), default=None)
                 for k in (0, 1))


def synchronising(fn):
    """(fn's result, the synchronising calls torch warned of inside it)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]


def counted(kernels, expected, fn):
    """Run fn with every launch count at 0; fail unless each kernel in
    `expected` launched. Returns (fn's result, the counts read just after)."""
    kernels.reset_launches()
    out = fn()
    counts = dict(kernels.LAUNCHES)
    missing = [k for k in expected if counts[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels {missing} were not launched on their path: {counts}")
    return out, counts


def cropped_part(b, with_bounds, Box):
    """A part cropped by with_bounds so that its surface crosses the
    render box's far faces: owner cubes there lie outside the grid, and
    the compact decoder and the welded emit cannot resolve them."""
    body = b.union(b.new_sphere(1.0), b.translate(b.new_box(0.5, 0.5, 2.5, 0.05), 0.3, 0.2, 0))
    return with_bounds(body, Box([-0.62] * 3, [0.62] * 3))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import bounds
        from gsdf_tpu_torch import (
            Builder, Flags, _build, cli, flagships, kernels, native, pipeline, render, with_bounds,
        )
        from gsdf_tpu_torch.eval import (
            Batcher, new_sdf3, normals_central_diff, special,
        )
        from gsdf_tpu_torch.eval import grid_kernels as gk
        from gsdf_tpu_torch.eval import parametric as par
        from gsdf_tpu_torch.eval import point_kernels as pk
        from gsdf_tpu_torch.eval import ray_kernels as rk
        from gsdf_tpu_torch.forge import threads
        from gsdf_tpu_torch.geometry.boxes import Box
        from gsdf_tpu_torch.ops import compact_field, dc_emit, fused_welded, mc_emit
        from gsdf_tpu_torch.ops.compact_field import compact_field_render
        from gsdf_tpu_torch.render.dual_contour import DualContourRenderer
        from gsdf_tpu_torch.render.flat import FlatRenderer
        from gsdf_tpu_torch.render.pruned import PrunedRenderer
        from gsdf_tpu_torch import stages
    except ImportError as e:
        print(f"chip_smoke: gsdf_tpu_torch not importable ({e}); run it in the "
              "repository root", file=sys.stderr)
        return 3
    import numpy as np

    # --- phase 1: the card -------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    if sys.argv[1:] == ["--raymarch"]:
        return raymarch_study(dev, card)
    if sys.argv[1:] == ["--dc"]:
        return dc_study(dev, card)

    # --- phase 2: build, compare, time ---------------------------------
    trees = {
        "nine-types": nine_type_tree(Builder(), threads),
        "every-type": every_type_tree(Builder(), threads, with_bounds, Box),
        "flange": flagships.build_flange(),
        "showerhead": flagships.build_showerhead(),
        "bolt": flagships.build_bolt(),
        "knurled": flagships.build_knurled(),
        "cropped": cropped_part(Builder(), with_bounds, Box),
    }
    for seed in FUZZ_SEEDS:
        tree = random_tree(Builder(Flags.NO_DIMENSION_PANIC), np.random.default_rng(seed))
        if tree is not None:
            trees[f"fuzz{seed}"] = tree
    # K5's trees: every 3D tree above and three more random ones
    dc_trees = dict(trees)
    for seed in DC_EXTRA_SEEDS:
        dc_trees[f"fuzz{seed}"] = random_tree(Builder(Flags.NO_DIMENSION_PANIC),
                                              np.random.default_rng(seed))
    # the 2D trees: one recipe per 2D node type, the example programs' three
    # PNG scenes at their sizes, and the special evaluators' trees
    trees2d = {f"2d:{k}": (t, 256, 192)
               for k, t in recipes_2d(Builder(), with_bounds, Box).items()}
    for name, make, width, height in flagships.PNG_SCENES:
        trees2d[name] = (make(Builder()), width, height)
    battery = special.benchmark_trees()
    point_trees = {**trees, **{k: t for k, (t, _, _) in trees2d.items()}, **battery}
    # a structurally equal tree with other values, for each parametric library
    others = {name: perturbed(tree) for name, tree in point_trees.items()}
    golden_parts = ("flange", "showerhead", "bolt", "knurled")
    # the raymarcher's trees: the six parts and three random trees
    rm_parts = {name: trees[name] for name in RM_PARTS if name in trees}
    rm_parts["sphere"] = Builder().new_sphere(1.0)
    rm_parts["geb"] = rm_geb()
    rm_trees = {**rm_parts, **{name: trees[name] for name in RM_FUZZ if name in trees}}
    t0 = time.perf_counter()
    # one nvcc per library, all queued together; 32 at a time keep the
    # host's cores busy without holding every compiler in memory at once
    with ThreadPoolExecutor(max_workers=32) as pool:
        futs = [pool.submit(kernels.build, tree) for tree in trees.values()]
        futs += [pool.submit(kernels.build, battery["deep_tree_3d"])]
        futs += [pool.submit(kernels.static_lib, n) for n in kernels.STATIC_KERNELS]
        futs += [pool.submit(kernels.build, tree, "point") for tree in point_trees.values()]
        futs += [pool.submit(kernels.build, tree, "field") for tree, _, _ in trees2d.values()]
        futs += [pool.submit(kernels.build, tree, "classified", True) for tree in trees.values()]
        futs += [pool.submit(kernels.build, tree, "point", True)
                 for tree in point_trees.values()]
        futs += [pool.submit(kernels.build, tree, "dc", parametric)
                 for tree in dc_trees.values() for parametric in (False, True)]
        futs += [pool.submit(kernels.build, tree, "prune", parametric)
                 for tree in trees.values() for parametric in (False, True)]
        futs += [pool.submit(kernels.build, tree, "raymarch", parametric)
                 for tree in rm_trees.values() for parametric in (False, True)]
        futs += [pool.submit(rm_occupancy, tree, parametric)
                 for tree in rm_parts.values() for parametric in (False, True)]
        for fut in futs:
            fut.result()
    build_s = time.perf_counter() - t0
    log(f"phase 2: built {len(futs)} kernel libraries ({len(trees) + 1} trees' K1 + K2, "
        f"{len(kernels.STATIC_KERNELS)} MC kernels, {len(point_trees)} trees' KP, "
        f"{len(trees2d)} 2D trees' K2-2D, {len(trees)} structures' K1p, {len(point_trees)} "
        f"structures' KPp, {len(dc_trees)} trees' K5 and K5p, {len(trees)} trees' K6c + K6a "
        f"and their parametric forms, {len(rm_trees)} trees' K8 and K8p, {len(rm_parts)} "
        f"parts' K8 and K8p occupancy probes; one nvcc each, in parallel) in {build_s:.1f} s; "
        f"compiler runs {_build.COUNTS['compiles']}, libraries loaded {_build.COUNTS['loads']}")
    n_params = {name: int(par.kernel_params(trees[name]).size) for name in golden_parts}
    log("  parameters per part (packed as the JAX package packs them / in the kernels' "
        "layout): " + ", ".join(f"{name} {par.pack_params(trees[name]).size} / {n_params[name]}"
                               for name in golden_parts))
    logs = [(name, kernels.build_log(tree)) for name, tree in trees.items()]
    logs += [(name, kernels.static_build_log(name)) for name in kernels.STATIC_KERNELS]
    logs += [(f"KP {name}", kernels.build_log(trees[name], "point"))
             for name in golden_parts]
    logs += [(f"K1p {name}", kernels.build_log(trees[name], "classified", True))
             for name in golden_parts]
    logs += [(f"KPp {name}", kernels.build_log(trees[name], "point", True))
             for name in golden_parts]
    logs += [(f"K2-2D {name}", kernels.build_log(trees2d[name][0], "field"))
             for name, _, _, _ in flagships.PNG_SCENES]
    logs += [(f"K5{'p' if p else ''} bolt", kernels.build_log(trees["bolt"], "dc", p))
             for p in (False, True)]
    logs += [(f"K6{'p' if p else ''} {name}", kernels.build_log(trees[name], "prune", p))
             for name in golden_parts for p in (False, True)]
    logs += [(f"K8{'p' if p else ''} {name}", kernels.build_log(tree, "raymarch", p))
             for name, tree in rm_parts.items() for p in (False, True)]
    for name, text in logs:
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels vs plain torch on the card")
    max_err = {name: 0.0 for name, _, _ in KERNELS}
    differing = {"classified_grid_param": 0, "point_eval_param": 0}  # floats, from baked
    grids = [("nine-types", 60), ("every-type", 90), ("cropped", 40)]
    grids += [(name, 64) for name in trees if name.startswith("fuzz")]
    grids += [("flange", 100), *MAIN_GRIDS]
    mc_inputs = {}
    # flange 800's soup runs two fused slabs: the second, at its shape and
    # plane offset k0, holds K1, K3, K7s (and K4, K7w) at k0 != 0
    slabs = [("flange", 800, 1)]
    for name, resdiv, slab in [(n, r, None) for n, r in grids] + slabs:
        label = f"{name}@{resdiv}" + ("" if slab is None else f" slab {slab}")
        errs, n_diff = compare(label, trees[name], resdiv, dev, gk, slab, others[name])
        differing["classified_grid_param"] += n_diff
        mc_errs, inputs = mc_compare(label, trees[name], resdiv, dev, gk, slab)
        errs.update(mc_errs)
        for k, v in errs.items():
            max_err[k] = max(max_err[k], v)
        if slab is None and (name, resdiv) in MAIN_GRIDS:
            mc_inputs[(name, resdiv)] = inputs
        del inputs

    # K6c, K6a, their parametric forms, the id map and K7s's tile mode: every
    # 3D tree at diag/64, tiles of 8 and of a size that leaves edge tiles
    # overhanging the grid
    pruned_diff = {}
    n_pruned_grids = 0
    for name, tree in trees.items():
        fr = FlatRenderer(tree, tree.bounds().diagonal() / 64, dev)
        odd = next(S for S in (7, 6, 5, 9) if any(n % S for n in (fr.nx, fr.ny, fr.nz)))
        for S in (8, odd):
            errs, diff = pruned_compare(name, tree, others[name], 64, S, dev, gk)
            for k, v in errs.items():
                max_err[k] = max(max_err[k], v)
            for k, v in diff.items():
                pruned_diff[k] = pruned_diff.get(k, 0) + v
            n_pruned_grids += 1
    log(f"phase 2: K6c, K6a, K6cp, K6ap, the id map and K7s's tile mode against plain (and "
        f"the atlas against K1) on {n_pruned_grids} grids of {len(trees)} trees: differing "
        f"{pruned_diff}")
    # the same at the main path's shapes: each full-width pruned render's
    # coarse grid, and its first batch of tiles_per_batch kept tiles
    pruned_full_diff = {}
    for name, resdiv in PRUNED_GRIDS:
        errs, diff = pruned_compare(name, trees[name], others[name], resdiv, 8, dev, gk,
                                    first_batch=True)
        for k, v in errs.items():
            max_err[k] = max(max_err[k], v)
        for k, v in diff.items():
            pruned_full_diff[k] = pruned_full_diff.get(k, 0) + v
        torch.cuda.empty_cache()
    log(f"phase 2: the same at full width, on the coarse grid and first batch (2,048 tiles) of "
        f"{', '.join(f'{n} {r}' for n, r in PRUNED_GRIDS)}: differing {pruned_full_diff}")

    # K5 and K5p: every 3D tree and ten random ones at diag/64, both modes;
    # the bolt at resdiv 256 (the main path's grid) and a slab of it
    bolt_res = trees["bolt"].bounds().diagonal() / 256
    dc_cases = [(name, tree, tree.bounds().diagonal() / 64, None, None)
                for name, tree in dc_trees.items()]
    dc_cases.append(("bolt@256", trees["bolt"], bolt_res, None, None))
    nz256 = DualContourRenderer(trees["bolt"], bolt_res, device=dev).nz
    dc_cases.append((f"bolt@256 slab k0={nz256 // 2}", trees["bolt"], bolt_res, (nz256 // 2, 24),
                     None))
    # rows below, at and one past a 32-voxel word: the word and row ends
    # of K5's word-level passes (tests/test_torch_dc_words.py on the CPU)
    dc_cases += [(f"bolt {label}", trees["bolt"], res, slab, grid)
                 for label, res, slab, grid in dc_grid_cases(trees["bolt"])]
    n_random = sum(1 for name, *_ in dc_cases if name.startswith("fuzz"))
    if n_random < 10:
        raise RuntimeError(f"K5 needs ten random trees, has {n_random}")
    dc_err = {"dc_mesh": 0.0, "dc_mesh_param": 0.0}  # max |d| / res
    dc_grid_differing = 0
    dc_edges_grids = 0
    for name, tree, res, slab, grid in dc_cases:
        for chiseled in (False, True):
            out, n_e, _, edges_differing = dc_compare(name, tree, res, dev, slab, chiseled, grid)
            if n_e == 0:
                raise RuntimeError(f"K5 {name}: no active edge, nothing compared")
            for k, (err, rel, n_grid) in out.items():
                max_err[k] = max(max_err[k], err)
                dc_err[k] = max(dc_err[k], rel)
                dc_grid_differing += n_grid
            dc_edges_grids += edges_differing is not None
    log(f"phase 2: K5 and K5p equal to plain on {len(dc_cases)} grids ({n_random} random "
        f"trees), both modes: max |d| / res {dc_err}, max |d| "
        f"{ {k: max_err[k] for k in dc_err} }; K5's grid against K2's: {dc_grid_differing} "
        f"floats differ; dc_edges (the host_qef=True render's input) equal to plain in ids, "
        f"flips, t and normals on {dc_edges_grids} grids")

    # KP at seeded points on every tree, 3D and 2D; K2-2D on every 2D tree
    for name, tree in point_trees.items():
        max_err["point_eval"] = max(max_err["point_eval"], compare_points(name, tree, dev, pk))
        err, n_diff = compare_points_param(name, tree, others[name], dev, pk)
        max_err["point_eval_param"] = max(max_err["point_eval_param"], err)
        differing["point_eval_param"] += n_diff
    log(f"  parametric against baked, over every grid and tree above: K1p's distances differ "
        f"from K1's in {differing['classified_grid_param']} floats, KPp's from KP's in "
        f"{differing['point_eval_param']} "
        f"({'bit-identical' if not any(differing.values()) else 'NOT bit-identical'})")
    for name, (tree, width, height) in trees2d.items():
        max_err["grid_eval_2d"] = max(max_err["grid_eval_2d"],
                                      compare_field(name, tree, width, height, dev, pk))

    # K8 and K8p at 128 x 128, aa 2, on the five parts and three random trees
    log(f"phase 2: K8 and K8p against raymarch_plain on {len(rm_trees)} trees")
    rm_differing = {}
    for name, tree in rm_trees.items():
        other = others[name] if name in others else perturbed(tree)
        rm_differing[name] = raymarch_compare(name, tree, other, dev)
        for k in ("raymarch", "raymarch_param"):
            max_err[k] = max(max_err[k], float(rm_differing[name][k][1]))

    # bounds: the tree's operations per corner, counted on the CPU
    ops_per_point = {name: bounds.tree_ops_per_point(trees[name])
                     for name in dict.fromkeys(n for n, _ in MAIN_GRIDS)}
    ops_per_point.update({name: bounds.tree_ops_per_point(trees2d[name][0])
                          for name, _, _, _ in flagships.PNG_SCENES})
    log(f"  tree operations per corner (plain torch on the CPU): {ops_per_point}")
    times = {}
    for name, resdiv in MAIN_GRIDS:
        tree = trees[name]
        dist, cases, comp, fr, sizes = mc_inputs.pop((name, resdiv))
        args = (tree, fr.origin, fr.res, fr.shape(), dev)
        versions = {
            "classified_grid": (lambda: gk.classified_grid(*args),
                                lambda: gk.classified_grid_plain(*args)),
            "grid_eval": (lambda: gk.evaluate_grid(*args), lambda: gk.evaluate_grid_plain(*args)),
            **mc_versions(dist, cases, comp, fr),
        }
        # one PyTorch call that computes the same function, timed as a
        # yardstick (the port never calls it); the other kernels have none
        library = {"compact_active": lambda: torch.nonzero(cases.reshape(-1))}
        tree_ops = ops_per_point[name] * sizes["corners"]
        ops = {"grid_eval": tree_ops,
               "classified_grid": tree_ops + bounds.count_ops(
                   mc_emit.effective_cases, dist, fr.res)[1]}
        row = {}
        for k, (kernel, plain) in versions.items():
            if k not in ops:
                ops[k] = bounds.count_ops(plain)[1]  # the plain version on these inputs
            lib = library.get(k)
            # plain, (library), kernel, kernel, (library), plain: in turns
            p1 = cuda_ms(plain, 3)
            l1 = cuda_ms(lib, 10) if lib else None
            k1, k2 = cuda_ms(kernel, 10), cuda_ms(kernel, 10)
            l2 = cuda_ms(lib, 10) if lib else None
            ms = min(k1, k2)
            b = bounds.bound(ops[k], bounds.kernel_bytes(k, **sizes))
            row[k] = {"ms": ms, "plain_ms": min(p1, cuda_ms(plain, 3)),
                      "library_ms": min(l1, l2) if lib else None, **b,
                      "share": b["bound_ms"] / ms,
                      "published_fp32_share": b["published_fp32_ms"] / ms}
        # K3 as the indexed path calls it, with K7w's edge-rank directory
        def with_ranks():
            return mc_emit.compact_active(cases, edge_ranks=True)

        row["compact_active"]["with_edge_ranks_ms"] = min(cuda_ms(with_ranks, 10),
                                                          cuda_ms(with_ranks, 10))
        row["k1_over_k2"] = row["classified_grid"]["ms"] / row["grid_eval"]["ms"]
        # K1p against the baked K1 in turns (baked, K1p, K1p, baked); its plain
        # version is K1's, timed above on these inputs; its operations are K1's
        def k1p():
            return gk.classified_grid(*args, 0, True)

        ms, baked_ms = in_turns(k1p, versions["classified_grid"][0])
        b = bounds.bound(ops["classified_grid"], bounds.kernel_bytes(
            "classified_grid_param", **sizes, n_params=n_params[name]))
        row["classified_grid_param"] = {
            "ms": ms, "baked_ms": baked_ms, "plain_ms": row["classified_grid"]["plain_ms"],
            "library_ms": None, **b, "share": b["bound_ms"] / ms,
            "published_fp32_share": b["published_fp32_ms"] / ms}
        versions["classified_grid_param"] = (k1p, versions["classified_grid"][1])
        times[f"{name}@{resdiv}"] = row
        log(f"  device ms {name}@{resdiv} grid {fr.shape()}: "
            + ", ".join(f"{k} {v['ms']:.3f} (bound {v['bound_ms']:.3f} by {v['bound_by']}, "
                        f"share {v['share']:.2f}, plain {v['plain_ms']:.3f}"
                        + (f", baked in turns {v['baked_ms']:.3f}" if "baked_ms" in v else "")
                        + (f", library {v['library_ms']:.3f})" if v["library_ms"] else ")")
                        for k, v in row.items() if k != "k1_over_k2")
            + f"; K3 with edge ranks {row['compact_active']['with_edge_ranks_ms']:.3f}"
            + f"; K1/K2 {row['k1_over_k2']:.3f}  [{card}]")
        # the device launches inside one call of each wrapper, and their time
        for k, (kernel, _) in versions.items():
            row[k]["on_device"] = device_launches(kernel)
        inside = {k: {n: v for n, v in row[k]["on_device"].items() if n != "device_ms"}
                  for k in versions}
        log(f"  on the card inside one wrapper call ({name}@{resdiv}): "
            + ", ".join(f"{k} {row[k]['on_device']}" for k in versions))
        # the pruned kernels' device ms come from CUDA graph replay: both
        # estimators on the same kernels here, in the same run
        for k in ("classified_grid", "compact_emit", "emit_soup"):
            row[k]["graph_ms"] = graph_ms(versions[k][0])
        log(f"  device ms two ways ({name}@{resdiv}): "
            + ", ".join(f"{k} profiler {row[k]['on_device']['device_ms']:.4f}, graph replay "
                        f"{row[k]['graph_ms'] and round(row[k]['graph_ms'], 4)}"
                        for k in ("classified_grid", "compact_emit", "emit_soup"))
            + f"  [{card}]")
        one_kernel = {"kernels": 1, "memsets": 0, "copies": 0}
        if inside["emit_soup"] != one_kernel or inside["compact_emit"] != one_kernel:
            raise RuntimeError(f"K7s and K4 should be one kernel launch and nothing else: {inside}")
        if inside["emit_welded"]["kernels"] > 2 or inside["emit_welded"]["copies"]:
            raise RuntimeError(f"K7w should be at most two launches and copy nothing: {inside}")
        del dist, cases, comp
    torch.cuda.empty_cache()

    # KP at the evaluators' full batch (2^20 seeded points) on the four
    # golden parts, K2-2D on the three scenes at the examples' sizes
    n_points = 1 << 20
    one_kernel = {"kernels": 1, "memsets": 0, "copies": 0}
    timed = []
    for name in golden_parts:
        tree, pos = trees[name], seeded_points(trees[name], n_points, 2, dev)
        timed.append((f"KP {name} N={n_points}", "point_eval", ops_per_point[name] * n_points,
                      {"points": n_points, "ndim": 3},
                      lambda tree=tree, pos=pos: pk.evaluate_points(tree, pos, dev),
                      lambda tree=tree, pos=pos: pk.point_eval_plain(tree, pos)))
        timed.append((f"KPp {name} N={n_points}", "point_eval_param",
                      ops_per_point[name] * n_points,
                      {"points": n_points, "ndim": 3, "n_params": n_params[name]},
                      lambda tree=tree, pos=pos: pk.evaluate_points(tree, pos, dev, True),
                      lambda tree=tree, pos=pos: pk.point_eval_plain(tree, pos)))
    for name, _, width, height in flagships.PNG_SCENES:
        tree = trees2d[name][0]
        timed.append((f"K2-2D {name} {width}x{height}", "grid_eval_2d",
                      ops_per_point[name] * width * height, {"pixels": width * height},
                      lambda tree=tree, w=width, h=height: pk.distance_field(tree, w, h, dev),
                      lambda tree=tree, w=width, h=height: pk.distance_field_plain(tree, w, h, dev)))
    baked_kp = {}  # label of a KP row -> its kernel call, for KPp's turns against it
    for label, kname, ops, sizes, kernel, plain in timed:
        ms, plain_ms = in_turns(kernel, plain)
        baked_kp[label] = kernel
        b = bounds.bound(ops, bounds.kernel_bytes(kname, **sizes))
        on_device = device_launches(kernel)
        times[label] = {kname: {"ms": ms, "plain_ms": plain_ms, "library_ms": None, **b,
                                "share": b["bound_ms"] / ms,
                                "device_share": b["bound_ms"] / on_device["device_ms"],
                                "published_fp32_share": b["published_fp32_ms"] / ms,
                                "on_device": on_device}}
        log(f"  device ms {label}: {kname} {ms:.4f} (on the card {on_device['device_ms']:.4f}, "
            f"bound {b['bound_ms']:.4f} by {b['bound_by']}, share {b['bound_ms'] / ms:.2f}, "
            f"plain {plain_ms:.3f}, no library call)  [{card}]")
        if {k: v for k, v in on_device.items() if k != "device_ms"} != one_kernel:
            raise RuntimeError(f"{label}: one wrapper call should be one kernel launch and "
                               f"nothing else: {on_device}")
        if kname == "point_eval_param":  # baked, KPp, KPp, baked
            ms, baked_ms = in_turns(kernel, baked_kp[label.replace("KPp", "KP")])
            times[label][kname]["baked_ms"] = baked_ms
            log(f"  device ms {label} in turns with the baked KP: {ms:.4f} against "
                f"{baked_ms:.4f}  [{card}]")
    del timed, baked_kp

    # the parameter argument by value (a kernel parameter, the constant
    # bank) against the pointer form (an upload, device memory): the pointer
    # libraries of the four parts, equal outputs, then in turns
    def form(by_value, fn):
        def call():
            kernels.PARAMS_BY_VALUE = by_value
            try:
                return fn()
            finally:
                kernels.PARAMS_BY_VALUE = None
        return call

    kernels.PARAMS_BY_VALUE = False  # one setting around all the threads' builds
    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = [pool.submit(kernels.build, trees[n], tm, True)
                    for n in golden_parts for tm in ("classified", "point")]
            for fut in futs:
                fut.result()
    finally:
        kernels.PARAMS_BY_VALUE = None
    for name, resdiv in MAIN_GRIDS:
        tree = trees[name]
        fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)
        args = (tree, fr.origin, fr.res, fr.shape(), dev, 0, True)
        by_value = form(None, lambda: gk.classified_grid(*args))
        by_pointer = form(False, lambda: gk.classified_grid(*args))
        (d_v, c_v), (d_p, c_p) = by_value(), by_pointer()
        if not (torch.equal(d_v, d_p) and torch.equal(c_v, c_p)):
            raise RuntimeError(f"K1p {name}@{resdiv}: the pointer form differs from by value")
        del d_v, c_v, d_p, c_p
        _, syncs = synchronising(by_pointer)
        ptr_ms, val_ms = in_turns(by_pointer, by_value)
        ptr_card, val_card = on_card_ms(by_pointer, by_value)
        times[f"{name}@{resdiv}"]["classified_grid_param"].update(
            by_pointer_ms=ptr_ms, by_pointer_on_card_ms=ptr_card, by_value_on_card_ms=val_card)
        log(f"  device ms K1p {name}@{resdiv}, {n_params[name]} parameters: by value "
            f"{val_ms:.3f} (on the card {val_card}), through a pointer {ptr_ms:.3f} (on the "
            f"card {ptr_card}, its upload included; {len(syncs)} synchronising calls in "
            f"it)  [{card}]")
    for name in golden_parts:
        tree, pos = trees[name], seeded_points(trees[name], n_points, 2, dev)
        by_value = form(None, lambda: pk.evaluate_points(tree, pos, dev, True))
        by_pointer = form(False, lambda: pk.evaluate_points(tree, pos, dev, True))
        if not torch.equal(by_value(), by_pointer()):
            raise RuntimeError(f"KPp {name}: the pointer form differs from by value")
        ptr_ms, val_ms = in_turns(by_pointer, by_value)
        ptr_card, val_card = on_card_ms(by_pointer, by_value)
        times[f"KPp {name} N={n_points}"]["point_eval_param"].update(
            by_pointer_ms=ptr_ms, by_pointer_on_card_ms=ptr_card, by_value_on_card_ms=val_card)
        log(f"  device ms KPp {name} N={n_points}: by value {val_ms:.4f} (on the card "
            f"{val_card}), through a pointer {ptr_ms:.4f} (on the card {ptr_card}, its "
            f"upload included)  [{card}]")
    if kernels.PARAMS_BY_VALUE is not None:
        raise RuntimeError("the parameter form override was left set")
    torch.cuda.empty_cache()

    # K5 at the bolt's resdiv 256 and 384 (one grid each, the main path's),
    # against its plain version; K5p in turns against K5. The bound's
    # operations are the plain version's on these inputs (bounds.py)
    for resdiv in (256, 384):
        dcr = DualContourRenderer(trees["bolt"], trees["bolt"].bounds().diagonal() / resdiv,
                                  device=dev)
        cont = dcr.contourer
        dargs = (trees["bolt"], dcr.origin, dcr.res, dcr.shape(), dev, cont.norm_step,
                 cont.sqrt_lambda)

        def k5(dargs=dargs):
            return dc_emit.dc_mesh(*dargs)

        def k5p(dargs=dargs):
            return dc_emit.dc_mesh(*dargs, parametric=True)

        def k5_plain(dargs=dargs):
            return dc_emit.dc_mesh_plain(*dargs)

        mesh, ops = bounds.count_ops(k5_plain)
        sizes = {"edges": len(mesh.eids), "voxels": len(mesh.verts)}
        del mesh
        row = {}
        ms, plain_ms = in_turns(k5, k5_plain)
        ms_p, baked_ms = in_turns(k5p, k5)
        for kname, kms, extra in (("dc_mesh", ms, {}),
                                  ("dc_mesh_param", ms_p, {"baked_ms": baked_ms})):
            b = bounds.bound(ops, bounds.kernel_bytes(kname, **sizes, n_params=n_params["bolt"]))
            on_device = device_reading(k5p if kname == "dc_mesh_param" else k5)
            device_ms = None if on_device is None else on_device["device_ms"]
            row[kname] = {"ms": kms, "plain_ms": plain_ms, "library_ms": None, **b,
                          "share": b["bound_ms"] / kms,
                          "device_share": device_ms and b["bound_ms"] / device_ms,
                          "published_fp32_share": b["published_fp32_ms"] / kms,
                          "on_device": on_device, **sizes, **extra}
            row[kname]["kernels_us"] = stages.device_us(k5p if extra else k5)
            log(f"  device ms K5{'p' if extra else ''} bolt@{resdiv} grid {dcr.shape()}: "
                f"{kms:.3f} (on the card {device_ms}: {on_device}; bound "
                f"{b['bound_ms']:.4f} by {b['bound_by']}, share {b['bound_ms'] / kms:.2f}, "
                f"{sizes['edges']} edges, {sizes['voxels']} voxels, plain {plain_ms:.3f}"
                + (f", baked K5 in turns {baked_ms:.3f}" if extra else "")
                + f", no library call; device us by kernel {row[kname]['kernels_us']})  "
                f"[{card}]")
        times[f"DC bolt@{resdiv}"] = row
    torch.cuda.empty_cache()

    # what one K5 call runs on the card (torch.profiler sees the device here,
    # not late in the run): the bolt's whole grid at 256, a chunk of its 512
    # render, and K5p at 256; phase 3's launches_per_render rows carry them
    bolt = trees["bolt"]
    dcr = DualContourRenderer(bolt, bolt_res, device=dev)
    dcr512 = DualContourRenderer(bolt, bolt.bounds().diagonal() / 512, device=dev)
    origin, shape, k0, n_own = dcr512.chunks()[0][1]

    def k5_call(r, origin, shape, k0=0, n_own=None, parametric=False):
        return lambda: dc_emit.dc_mesh(bolt, origin, r.res, shape, dev, r.contourer.norm_step,
                                       r.contourer.sqrt_lambda, k0, n_own, parametric)

    dc_card = {
        "dc bolt@256": dc_on_card("K5 bolt@256", k5_call(dcr, dcr.origin, dcr.shape())),
        "dc bolt@512": dc_on_card("K5 bolt@512, a chunk",
                                  k5_call(dcr512, origin, shape, k0, n_own)),
        "dc parametric edit": dc_on_card("K5p bolt@256", k5_call(dcr, dcr.origin, dcr.shape(),
                                                                 parametric=True)),
    }
    log(f"phase 2: what one K5 call runs on the card (at most {DC_KERNELS_PER_CALL} kernels, "
        f"no memset): {dc_card}")

    # K5p's parameter argument by value against the pointer form, bolt@256
    kernels.PARAMS_BY_VALUE = False
    try:
        kernels.build(trees["bolt"], "dc", True)
    finally:
        kernels.PARAMS_BY_VALUE = None
    dcr = DualContourRenderer(trees["bolt"], bolt_res, device=dev)
    dargs = (trees["bolt"], dcr.origin, dcr.res, dcr.shape(), dev, dcr.contourer.norm_step,
             dcr.contourer.sqrt_lambda)
    by_value = form(None, lambda: dc_emit.dc_mesh(*dargs, parametric=True))
    by_pointer = form(False, lambda: dc_emit.dc_mesh(*dargs, parametric=True))
    if not all(torch.equal(a, b) for a, b in zip(by_value(), by_pointer())):
        raise RuntimeError("K5p bolt@256: the pointer form differs from by value")
    ptr_ms, val_ms = in_turns(by_pointer, by_value)
    ptr_card, val_card = on_card_ms(by_pointer, by_value)
    times["DC bolt@256"]["dc_mesh_param"].update(
        by_pointer_ms=ptr_ms, by_pointer_on_card_ms=ptr_card, by_value_on_card_ms=val_card)
    log(f"  device ms K5p bolt@256: by value {val_ms:.3f} (on the card {val_card}), through "
        f"a pointer {ptr_ms:.3f} (on the card {ptr_card}, its upload included)  [{card}]")
    if kernels.PARAMS_BY_VALUE is not None:
        raise RuntimeError("the parameter form override was left set")
    torch.cuda.empty_cache()

    # the pruned kernels at flange 400, against their plain versions
    times["pruned flange@400"] = pruned_kernel_times(trees["flange"], 400, dev, gk,
                                                     n_params["flange"], card)
    torch.cuda.empty_cache()
    rm_times, rm_refs = raymarch_kernel_times(rm_parts, dev, card)
    flange_rm = rm_times["flange"]["image aa1"]
    times["raymarch flange 512"] = {
        "raymarch": {**flange_rm, "on_device": device_reading(
            lambda: rk.raymarch(trees["flange"], *rm_args(trees["flange"], 512, 512, 196, 1,
                                                          dev)))},
        "raymarch_param": {**flange_rm, **bounds.bound(flange_rm["ops"], flange_rm["param_bytes"]),
                           "ms": flange_rm["param_ms"], "graph_ms": flange_rm["param_graph_ms"],
                           "on_device": None},
    }
    times["raymarch flange 512"]["raymarch_param"]["share"] = (
        times["raymarch flange 512"]["raymarch_param"]["bound_ms"] / flange_rm["param_ms"])
    torch.cuda.empty_cache()

    # --- phases 3 and 4: each path, counts from 0 around each run -------
    launches = {k: 0 for k in kernels.LAUNCHES}
    e2e = {}
    per_render = {}  # launches per render of each kernel, per path and part

    def run(label, expected, fn):
        out, counts = counted(kernels, expected, fn)
        for k, n in counts.items():
            launches[k] += n
        log(f"phase 3: {label}: launches {counts}")
        return out, counts

    compact_path = ("classified_grid", "compact_active", "compact_emit")
    soup_path = ("classified_grid", "compact_active", "emit_soup")
    welded_path = ("classified_grid", "compact_active", "emit_welded")
    goldens = {
        ("flange", 400): flagships.GOLDEN_FLANGE_TRIS,
        ("showerhead", 350): flagships.GOLDEN_SHOWERHEAD_TRIS,
        ("flange", 800): flagships.GOLDEN_FLANGE_800_TRIS,
        ("bolt", 300): flagships.GOLDEN_BOLT_TRIS,
        ("knurled", 350): flagships.GOLDEN_KNURLED_TRIS,
    }
    benches = [("compact", compact_path, name, resdiv, 5) for name, resdiv in MAIN_GRIDS]
    for name, resdiv in MAIN_GRIDS[:3]:
        benches.append(("soup", soup_path, name, resdiv, 3))
        via_weld = name == "flange" and resdiv == 800  # past slab_cubes
        benches.append(("indexed", soup_path if via_weld else welded_path, name, resdiv, 3))
    for path, expected, name, resdiv, reps in benches:
        golden = goldens[(name, resdiv)]
        (ms, ntris, all_ms), counts = run(
            f"{path} {name}@{resdiv}", expected,
            lambda: cli.bench_part(trees[name], resdiv, golden, reps, dev, path),
        )
        e2e[f"{path} {name}@{resdiv}"] = ms
        per_render[f"{path} {name}@{resdiv}"] = {
            k: n / (reps + 2) for k, n in counts.items() if n}  # two warm-ups + reps
        slabs = 2 if (name, resdiv) == ("flange", 800) and path != "compact" else 1
        if per_render[f"{path} {name}@{resdiv}"] != {k: slabs for k in expected}:
            raise RuntimeError(f"{path} {name}@{resdiv}: expected one call of each of {expected} "
                               f"per render and slab, got {per_render[f'{path} {name}@{resdiv}']}")
        log(f"phase 3: {path} {name} resdiv {resdiv}: {ntris} triangles (golden {golden}), "
            f"SDF->STL warm median {ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in all_ms)}) "
            f"[{card}]")

    f800 = trees["flange"]
    res800 = f800.bounds().diagonal() / 800
    soup, counts = run("render() flange@800, one render", soup_path,
                       lambda: FlatRenderer(f800, res800, dev).render())
    if counts["classified_grid"] != 2 or counts["emit_soup"] != 2:
        raise RuntimeError(f"flange 800's soup should run two fused slabs: {counts}")
    # the staged path evaluates the whole grid with K2 and emits at k0 = 0:
    # a slab offset dropped or misapplied in K1 or K7s shows as a difference
    staged, counts = run("staged render(fused=False) flange@800, one whole grid",
                         ("grid_eval", "compact_active", "emit_soup"),
                         lambda: FlatRenderer(f800, res800, dev).render(fused=False))
    per_render["staged flange@800"] = {k: n for k, n in counts.items() if n}
    if len(soup) != flagships.GOLDEN_FLANGE_800_TRIS or not np.array_equal(staged, soup):
        raise RuntimeError("flange 800's two fused slabs differ from the staged whole-grid soup")
    log(f"phase 3: flange@800: the two fused slabs' soup equals the staged whole-grid soup "
        f"bit for bit ({len(staged)} triangles)")
    del staged
    (verts, tri), counts = run("render_indexed() flange@800, one render", soup_path,
                               lambda: FlatRenderer(f800, res800, dev).render_indexed())
    if counts["emit_welded"] or len(tri) != len(soup) or not np.array_equal(verts[tri], soup):
        raise RuntimeError("flange 800's render_indexed is not the host weld of its soup")
    del soup, verts, tri

    f400 = trees["flange"]
    res400 = f400.bounds().diagonal() / 400

    # one synchronising read (K3's counts) before the fetch, and one fetch
    fr = FlatRenderer(f400, res400, dev)
    grid_args = (f400, fr.origin, fr.res, fr.shape(), dev)

    def emitted(indexed):
        dist, cases = gk.classified_grid(*grid_args)
        comp = mc_emit.compact_active(cases, edge_ranks=indexed)
        if indexed:
            return fused_welded.emit_welded(dist, cases, comp.ids, fr.origin, fr.res, comp=comp)
        return mc_emit.emit_triangles(dist, cases, comp.ids, fr.origin, fr.res, 0, comp.n_tris,
                                      comp.tri_offsets)

    for label, until_fetch, whole in (
        ("soup", lambda: emitted(False), lambda: FlatRenderer(f400, res400, dev).render()),
        ("indexed", lambda: emitted(True), lambda: fused_welded.welded_render(*grid_args)),
    ):
        _, before = synchronising(until_fetch)
        _, render_syncs = synchronising(whole)
        log(f"phase 3: {label} flange@400: {len(before)} synchronising call before the fetch, "
            f"{len(render_syncs)} in a whole render (K3's count read, then the fetch)")
        if len(before) != 1 or len(render_syncs) != 2:
            raise RuntimeError(f"{label}: expected one read before the fetch and one fetch: "
                               f"{before} / {render_syncs}")

    sphere = Builder().new_sphere(1.0)
    sfr = FlatRenderer(sphere, 1.0 / 33, dev)
    tris, _ = run("sphere r=1 @ r/33 render()", soup_path, sfr.render)
    if len(tris) != 41072 or sfr.evaluations() != 68**3:
        raise RuntimeError(f"sphere golden: {len(tris)} != 41072 or {sfr.evaluations()} "
                           "evaluations != 68^3")
    log(f"phase 3: sphere golden: {len(tris)} triangles, {sfr.evaluations()} evaluations")

    cropped = trees["cropped"]
    cres = cropped.bounds().diagonal() / 40
    (verts, tri), _ = run("cropped part render_compact (fallback)",
                          compact_path + ("emit_welded", "emit_soup"),
                          lambda: FlatRenderer(cropped, cres, dev).render_compact())
    csoup = FlatRenderer(cropped, cres, dev).render()
    if tri.max() >= len(verts) or not np.array_equal(verts[tri], csoup):
        raise RuntimeError("the cropped part's fallback mesh is not its welded soup")
    log(f"phase 3: cropped part: fallback to the welded soup, {len(tri)} triangles, "
        f"{len(verts)} vertices")

    whole = FlatRenderer(f400, res400, dev)
    wv, wt = whole.render_compact()
    sl = FlatRenderer(f400, res400, dev)
    sl.compact_cubes = -(-sl.shape()[0] // 3) * sl.shape()[1] * sl.shape()[2]
    (sv, st), counts = run("slabbed render_compact flange@400", compact_path, sl.render_compact)
    if counts["classified_grid"] < 3 or not (np.array_equal(st, wt) and np.array_equal(sv, wv)):
        raise RuntimeError(f"the slabbed compact render differs from the whole grid's: {counts}")
    log(f"phase 3: slabbed compact flange@400: {counts['classified_grid']} slabs, equal to "
        f"the whole-grid render ({len(st)} triangles)")
    del wv, wt, sv, st

    for name, resdiv in (("flange", 400), ("bolt", 300), ("knurled", 350)):
        tree = trees[name]
        fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv, dev)

        def dense():
            field = gk.evaluate_grid(tree, fr.origin, fr.res, fr.shape(), dev)
            torch.cuda.synchronize()
            return field

        field, counts = run(f"evaluate_grid {name}@{resdiv}", ("grid_eval",), dense)
        per_render[f"evaluate_grid {name}@{resdiv}"] = {k: n for k, n in counts.items() if n}
        if not bool(torch.isfinite(field).all()):
            raise RuntimeError(f"evaluate_grid: non-finite distances on {name}")
        del field
    # --- the point and 2D slice, at full width, on the default device ---
    def host_ms(fn, reps=3):
        """(fn's last result, median host-clock ms of `reps` calls that end
        synchronised)."""
        out, ms = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, sorted(ms)[len(ms) // 2]

    def exactly(label, counts, want):
        """Fail unless the launches counted around one call are exactly `want`."""
        got = {k: n for k, n in counts.items() if n}
        if got != want:
            raise RuntimeError(f"{label}: expected launches {want}, got {got}")

    slice_ms = {}
    for name in ("flange", "showerhead", "bolt", "knurled"):
        tree = trees[name]
        sdf, counts = run(f"new_sdf3({name}), the constructor's smoke eval", ("point_eval",),
                          lambda: new_sdf3(tree))
        exactly(f"new_sdf3({name})", counts, {"point_eval": 1})
        if sdf.device != dev or sdf.evaluations() != 0:
            raise RuntimeError(f"new_sdf3({name}) is not a fresh evaluator on the card: "
                               f"{sdf.device}, {sdf.evaluations()} evaluations")
        pts = seeded_points(tree, n_points, 3, "cpu").numpy()
        sdf.evaluate(pts)  # warm-up
        (d, whole_ms), counts = run(f"SDF3.evaluate {name} N={n_points}", ("point_eval",),
                                    lambda: host_ms(lambda: sdf.evaluate(pts)))
        exactly(f"SDF3.evaluate {name}", counts, {"point_eval": 3})  # one a call, three calls
        if d.shape != (n_points,) or d.dtype != np.float32 or sdf.evaluations() != 4 * n_points:
            raise RuntimeError(f"SDF3.evaluate {name}: {d.shape} {d.dtype}, "
                               f"{sdf.evaluations()} evaluations")
        pos, upload_ms = host_ms(lambda: torch.from_numpy(pts).to(dev))
        held_to_plain(f"SDF3.evaluate   {name:22s} {n_points} points",
                      torch.from_numpy(d).to(dev), pk.point_eval_plain(tree, pos))
        on_card, syncs = synchronising(lambda: sdf.evaluate_device(pos))
        if syncs:
            raise RuntimeError(f"evaluate_device made synchronising calls: {syncs}")
        _, fetch_ms = host_ms(on_card.cpu)
        if not np.array_equal(on_card.cpu().numpy(), d):
            raise RuntimeError(f"{name}: evaluate_device differs from evaluate")
        kernel_ms = times[f"KP {name} N={n_points}"]["point_eval"]["ms"]
        slice_ms[f"SDF3.evaluate {name} N={n_points}"] = {
            "whole_call_ms": whole_ms, "upload_ms": upload_ms, "kernel_ms": kernel_ms,
            "fetch_ms": fetch_ms}
        log(f"phase 3: SDF3.evaluate {name} at {n_points} points: whole call {whole_ms:.3f} ms "
            f"host to host (upload of {pts.nbytes / 1e6:.1f} MB {upload_ms:.3f}, KP "
            f"{kernel_ms:.4f}, fetch of {d.nbytes / 1e6:.1f} MB {fetch_ms:.3f}); "
            f"evaluate_device: no synchronising call  [{card}]")
        del pos, on_card

    rates, counts = run(f"eval.special.run_benchmarks N={n_points}", ("point_eval", "grid_eval"),
                        lambda: special.run_benchmarks(n_points, log=lambda m: log("  " + m)))
    # four evaluators: the constructor's launch, a warm-up and five timed
    # calls each; throughput_grid: a warm-up and five timed grids
    exactly("run_benchmarks", counts, {"point_eval": 4 * 7, "grid_eval": 6})
    if not all(math.isfinite(v) and v > 0 for v in rates.values()):
        raise RuntimeError(f"run_benchmarks: {rates}")
    slice_ms["run_benchmarks evals per second"] = rates

    bolt = trees["bolt"]
    bolt_sdf = new_sdf3(bolt)
    n_normals = 1 << 18
    npts = seeded_points(bolt, n_normals, 4, "cpu").numpy()
    step = float(bolt.bounds().diagonal() / 300)
    normals_central_diff(bolt_sdf, npts, step)  # warm-up
    (normals, normals_ms), counts = run(
        f"normals_central_diff bolt N={n_normals}", ("point_eval",),
        lambda: host_ms(lambda: normals_central_diff(bolt_sdf, npts, step), 1))
    exactly("normals_central_diff", counts, {"point_eval": 6})
    six_call, six_ms = host_ms(lambda: normals_central_diff(HostOnly(bolt_sdf), npts, step), 1)
    if not (np.isfinite(normals).all() and np.array_equal(normals, six_call)):
        raise RuntimeError("normals_central_diff differs from its six-call host form")
    if bolt_sdf.evaluations() != 18 * n_normals:
        raise RuntimeError(f"normals: {bolt_sdf.evaluations()} evaluations")
    pos = torch.from_numpy(npts).to(dev)
    six_kp_ms = 6 * cuda_ms(lambda: bolt_sdf.evaluate_device(pos), 10)
    slice_ms[f"normals_central_diff bolt N={n_normals}"] = {
        "one_upload_ms": normals_ms, "six_call_host_form_ms": six_ms, "six_kp_launches_ms": six_kp_ms}
    log(f"phase 3: normals_central_diff bolt at {n_normals} points: {normals_ms:.3f} ms with one "
        f"upload (six KP launches {six_kp_ms:.4f} ms of it), bit for bit the six-call host "
        f"form's ({six_ms:.3f} ms)  [{card}]")
    del pos

    import tempfile

    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        for name, _, width, height in flagships.PNG_SCENES:
            tree = trees2d[name][0]
            path = os.path.join(tmp, f"{name}.png")
            pipeline.render_png_file_2d(path, tree, width, height)  # warm-up
            (img, png_ms), counts = run(
                f"render_png_file_2d {name} {width}x{height}", ("grid_eval_2d",),
                lambda: host_ms(lambda: pipeline.render_png_file_2d(path, tree, width, height), 1))
            exactly(f"render_png_file_2d {name}", counts, {"grid_eval_2d": 1})
            with Image.open(path) as f:
                back = np.asarray(f)
            want = render.bw_conversion(pk.distance_field_plain(tree, width, height, dev).cpu().numpy())
            if img.shape != (height, width, 4) or img.dtype != np.uint8 \
                    or not np.array_equal(back, img) or not np.array_equal(img, want):
                raise RuntimeError(f"{name}: the PNG, the image and the plain version's image "
                                   f"differ ({int((img != want).any(-1).sum())} pixels from plain)")
            inside = int((img[..., 0] == 0).sum())
            if not 0 < inside < width * height:
                raise RuntimeError(f"{name}: {inside} pixels inside of {width * height}")
            slice_ms[f"render_png_file_2d {name} {width}x{height}"] = png_ms
            log(f"phase 3: render_png_file_2d {name} {width}x{height}: {png_ms:.2f} ms to the "
                f"file, {inside} pixels inside, PNG read back equal to the image and to the "
                f"plain version's  [{card}]")
        # the showerhead's own argument renders the same thread profile
        path = os.path.join(tmp, "thread.png")
        _, counts = run("showerhead_scene(thread_png=...)", ("grid_eval_2d",),
                        lambda: flagships.showerhead_scene(Builder(), thread_png=path))
        exactly("showerhead_scene(thread_png)", counts, {"grid_eval_2d": 1})
        with Image.open(path) as f, Image.open(os.path.join(tmp, "showerhead-thread.png")) as g:
            if f.size != (512, 512) or not np.array_equal(np.asarray(f), np.asarray(g)):
                raise RuntimeError("showerhead_scene's thread PNG differs from the scene's")

    import io

    stl = io.BytesIO()
    stats, counts = run("pipeline.render_shader3d flange@400, STL in memory", compact_path,
                        lambda: pipeline.render_shader3d(f400, pipeline.RenderConfig(
                            stl_output=stl, resolution=float(res400), silent=True)))
    exactly("render_shader3d", counts, {k: 1 for k in compact_path})
    if stats["triangles"] != flagships.GOLDEN_FLANGE_TRIS \
            or not stats["stl_bytes"] == len(stl.getvalue()) == 84 + 50 * stats["triangles"] \
            or stats["evaluations"] != math.prod(FlatRenderer(f400, res400, dev).shape()):
        raise RuntimeError(f"render_shader3d flange@400: {stats['triangles']} triangles, "
                           f"{stats['stl_bytes']} STL bytes, {stats['evaluations']} evaluations")
    log(f"phase 3: render_shader3d flange@400: {stats['triangles']} triangles (golden "
        f"{flagships.GOLDEN_FLANGE_TRIS}), {stats['stl_bytes']} STL bytes, render "
        f"{stats['render_seconds'] * 1e3:.2f} ms, STL {stats['stl_seconds'] * 1e3:.2f} ms  [{card}]")
    del stl, stats

    rng = np.random.default_rng(5)
    buf_a, buf_b = rng.normal(size=(2, n_points)).astype(np.float32)

    def batcher_round():
        batcher = Batcher()
        dst = np.empty_like(buf_a)
        return (batcher.union(None, buf_a, buf_b), batcher.diff(None, buf_a, buf_b),
                batcher.intersect(None, buf_a, buf_b),
                batcher.execute_raw_binary_operation(lambda x, y: x * 2 + y, dst, buf_a, buf_b))

    (outs, batch_ms), counts = run(f"Batcher round on two buffers of {n_points}", (),
                                   lambda: host_ms(batcher_round, 1))
    exactly("Batcher", counts, {})  # torch.minimum / maximum on the card: no kernel of the port
    wants = (np.minimum(buf_a, buf_b), np.maximum(buf_a, -buf_b), np.maximum(buf_a, buf_b),
             buf_a * 2 + buf_b)
    if not all(np.array_equal(o, w) for o, w in zip(outs, wants)):
        raise RuntimeError("Batcher: a result differs from numpy's")
    slice_ms[f"Batcher four operations N={n_points}"] = batch_ms
    log(f"phase 3: Batcher union, diff, intersect and a custom operation on two buffers of "
        f"{n_points}: equal to numpy's, {batch_ms:.2f} ms host to host  [{card}]")
    # --- the parametric slice: the edit loop through the entry points ----
    import copy

    k1p_compact = ("classified_grid_param", "compact_active", "compact_emit")
    k1p_welded = ("classified_grid_param", "compact_active", "emit_welded")
    param_ms = {}
    for name, resdiv in (("flange", 400), ("showerhead", 350), ("bolt", 300), ("knurled", 350)):
        golden = goldens[(name, resdiv)]
        (ms, ntris, all_ms), counts = run(
            f"compact parametric {name}@{resdiv}", k1p_compact,
            lambda: cli.bench_part(trees[name], resdiv, golden, 5, dev, "compact", True))
        got = {k: n / 7 for k, n in counts.items() if n}  # two warm-ups + five
        per_render[f"compact parametric {name}@{resdiv}"] = got
        if got != {k: 1 for k in k1p_compact}:
            raise RuntimeError(f"compact parametric {name}@{resdiv}: expected one call of each "
                               f"of {k1p_compact} per render and no baked K1, got {got}")
        fr = FlatRenderer(trees[name], trees[name].bounds().diagonal() / resdiv, dev)
        grid = (trees[name], fr.origin, fr.res, fr.shape(), dev)
        same = [np.array_equal(a, b) for a, b in zip(
            compact_field_render(*grid, 0, True), compact_field_render(*grid))]
        if not all(same):
            raise RuntimeError(f"{name}@{resdiv}: the parametric payload (ids, cases, t) "
                               f"differs from the baked one: {same}")
        param_ms[f"compact parametric {name}@{resdiv}"] = {
            "ms": ms, "baked_ms": e2e[f"compact {name}@{resdiv}"]}
        log(f"phase 3: compact parametric {name} resdiv {resdiv}: {ntris} triangles (golden "
            f"{golden}), ids, case bytes and t equal to the baked render's; SDF->STL warm "
            f"median {ms:.2f} ms (baked {e2e[f'compact {name}@{resdiv}']:.2f})  [{card}]")

    def same_mesh(a, b):
        return all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))

    # the edit loop: the flange pinned by with_bounds, one dimension an edit;
    # each path edits a copy of its own, to other values, so that every
    # baked render of an edited tree is a tree no library was built for
    def edit_case(r, k, dz):
        flange = copy.deepcopy(trees["flange"])
        diff = flange.s  # Scale -> Difference(SmoothUnion(pipe, plate), through-hole)
        hole, blend, plate = diff.s2, diff.s1, diff.s1.s2
        return with_bounds(flange, flange.bounds()), [
            ("the through-hole's radius", {hole: {"r": hole.r * np.float32(r)}}),
            ("the smooth union's blend radius", {blend: {"k": blend.k * np.float32(k)}}),
            ("the plate's offset", {plate: {"p_": plate.p_ + np.float32([0, 0, dz])}}),
        ]

    for path, expected, case in (("render_compact", k1p_compact, (1.25, 0.5, 0.05)),
                                 ("render_indexed", k1p_welded, (1.15, 0.7, 0.03))):
        pinned, edits = edit_case(*case)
        fr = FlatRenderer(pinned, res400, dev)
        first, _ = run(f"edit loop {path}: the first parametric render", expected,
                       lambda: getattr(fr, path)(parametric=True))
        built = (dict(_build.COUNTS), len(kernels._libs))
        loop_ms, baked_loop_ms, sizes = [], [], [len(first[1])]
        for what, edit in edits:
            t0 = time.perf_counter()
            pinned.rebind(edit)
            mesh, counts = run(f"edit loop {path}: {what}", expected,
                               lambda: getattr(fr, path)(parametric=True))
            loop_ms.append((time.perf_counter() - t0) * 1e3)
            exactly(f"edit loop {path}", counts, {k: 1 for k in expected})
            if (dict(_build.COUNTS), len(kernels._libs)) != built:
                raise RuntimeError(f"edit loop {path}: an edit built or loaded a library: "
                                   f"{_build.COUNTS}, {len(kernels._libs)} libraries, were {built}")
            sizes.append(len(mesh[1]))
            # the baked loop: the edited tree is a new tree hash, a new source, an nvcc run
            compiles = _build.COUNTS["compiles"]
            t0 = time.perf_counter()
            baked = getattr(FlatRenderer(pinned, res400, dev), path)()
            baked_loop_ms.append((time.perf_counter() - t0) * 1e3)
            if _build.COUNTS["compiles"] != compiles + 1:
                raise RuntimeError(f"edit loop {path}: the baked render of an edited tree made "
                                   f"{_build.COUNTS['compiles'] - compiles} compiler runs")
            built = (dict(_build.COUNTS), len(kernels._libs))
            if not same_mesh(mesh, baked):
                raise RuntimeError(f"edit loop {path}, {what}: the parametric mesh differs from "
                                   "the baked render of the edited tree")
        if len(set(sizes)) != len(sizes):
            raise RuntimeError(f"edit loop {path}: an edit did not change the mesh: {sizes}")
        param_ms[f"edit loop {path} flange@400"] = {
            "edit_to_mesh_ms": loop_ms, "baked_edit_to_mesh_ms": baked_loop_ms}
        log(f"phase 3: edit loop {path} flange@400 pinned: {len(edits)} rebinds, 0 compiler "
            f"runs and 0 libraries loaded by the parametric renders, triangles {sizes}, each "
            f"mesh equal to the baked render of the edited tree; edit to mesh "
            f"{', '.join(f'{t:.2f}' for t in loop_ms)} ms parametric, "
            f"{', '.join(f'{t:.0f}' for t in baked_loop_ms)} ms baked (its nvcc run included)  "
            f"[{card}]")

    # one member of the showerhead's 130-hole loop group, moved
    shower = copy.deepcopy(trees["showerhead"])
    spinned = with_bounds(shower, shower.bounds())
    holes = next(n for n in shower.visit_bfs() if len(n.children()) > 100)
    member = holes.joined[40]
    sfr = FlatRenderer(spinned, shower.bounds().diagonal() / 350, dev)
    before = sfr.render_compact(parametric=True)
    built = (dict(_build.COUNTS), len(kernels._libs))
    spinned.rebind({member: {"p_": member.p_ + np.float32([0.9, 0, 0])}})
    moved, counts = run("showerhead: one hole of the loop group moved", k1p_compact,
                        lambda: sfr.render_compact(parametric=True))
    if (dict(_build.COUNTS), len(kernels._libs)) != built:
        raise RuntimeError("the showerhead's member edit built or loaded a library")
    if same_mesh(before, moved) or len(before[1]) != flagships.GOLDEN_SHOWERHEAD_TRIS:
        raise RuntimeError("the showerhead's member edit is not seen in the mesh")
    if not same_mesh(moved, FlatRenderer(spinned, sfr.res, dev).render_compact()):
        raise RuntimeError("the showerhead's member edit differs from the baked render")
    log(f"phase 3: showerhead@350: one of the 130 holes moved by rebind: {len(before[1])} -> "
        f"{len(moved[1])} triangles through the same library, equal to the baked render of "
        "the edited tree")
    del before, moved

    # one synchronising read before the fetch on the parametric path too
    def emitted_param():
        dist, cases = gk.classified_grid(*grid_args, 0, True)
        comp = mc_emit.compact_active(cases, edge_ranks=True)
        return fused_welded.emit_welded(dist, cases, comp.ids, grid_args[1], grid_args[2],
                                        comp=comp)

    _, before_fetch = synchronising(emitted_param)
    _, render_syncs = synchronising(lambda: fused_welded.welded_render(*grid_args, True))
    log(f"phase 3: parametric indexed flange@400: {len(before_fetch)} synchronising call before "
        f"the fetch, {len(render_syncs)} in a whole render")
    if len(before_fetch) != 1 or len(render_syncs) != 2:
        raise RuntimeError(f"parametric indexed: expected one read before the fetch and one "
                           f"fetch: {before_fetch} / {render_syncs}")

    # ParametricSDF3 on the default device: two trees of one structure, one library
    for name in golden_parts:
        tree, other = trees[name], others[name]
        psdf = par.ParametricSDF3(tree)
        pts = seeded_points(tree, n_points, 3, "cpu").numpy()
        psdf.evaluate(pts)  # warm-up
        built = (dict(_build.COUNTS), len(kernels._libs))
        (d, whole_ms), counts = run(f"ParametricSDF3.evaluate {name} N={n_points}",
                                    ("point_eval_param",),
                                    lambda: host_ms(lambda: psdf.evaluate(pts)))
        exactly(f"ParametricSDF3.evaluate {name}", counts, {"point_eval_param": 3})
        d2, counts = run(f"ParametricSDF3.evaluate {name}, another tree's values",
                         ("point_eval_param",), lambda: psdf.evaluate(pts, other))
        exactly(f"ParametricSDF3.evaluate {name}, other", counts, {"point_eval_param": 1})
        if psdf.device != dev or (dict(_build.COUNTS), len(kernels._libs)) != built:
            raise RuntimeError(f"ParametricSDF3 {name}: not on the card, or a second tree "
                               "built or loaded a library")
        pos = torch.from_numpy(pts).to(dev)
        for label, got, t in (("", d, tree), (" other values", d2, other)):
            held_to_plain(f"ParametricSDF3  {name:22s}{label}", torch.from_numpy(got).to(dev),
                          pk.point_eval_plain(t, pos))
        param_ms[f"ParametricSDF3.evaluate {name} N={n_points}"] = {
            "whole_call_ms": whole_ms,
            "baked_whole_call_ms": slice_ms[f"SDF3.evaluate {name} N={n_points}"]["whole_call_ms"]}
        log(f"phase 3: ParametricSDF3.evaluate {name} at {n_points} points: whole call "
            f"{whole_ms:.3f} ms host to host ({psdf.n_params()} parameters; SDF3.evaluate "
            f"{param_ms[f'ParametricSDF3.evaluate {name} N={n_points}']['baked_whole_call_ms']:.3f}"
            f"); a structurally equal tree through the same library: equal to its plain "
            f"version  [{card}]")
        del pos

    # what a parametric render pays on the host before its launch
    host_walk = {}
    for name in golden_parts:
        tree = trees[name]

        def cold():
            t = copy.copy(tree)  # a root without the caches
            t.__dict__.pop("_structural_hash_cache", None)
            t.__dict__.pop("_param_layout_cache", None)
            return par.structural_hash(t), par.pack_params(t)

        def per_ms(fn, reps=20):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps

        host_walk[name] = {
            "nodes": tree.node_count(), "n_params": n_params[name],
            "structural_hash_and_pack_params_uncached_ms": per_ms(cold),
            "per_render_cached_ms": per_ms(
                lambda: (par.structural_hash(tree), par.kernel_params(tree)))}
    log(f"phase 3: host ms of pack_params + structural_hash per part: {host_walk}")
    param_ms["host_walk"] = host_walk

    # --- the dual contouring slice, on the default device ------------------
    import io

    bolt = trees["bolt"]
    dc_slice = {}
    dc_tris = {}
    for resdiv, golden in DC_GOLDENS:
        res = bolt.bounds().diagonal() / resdiv
        dcr = DualContourRenderer(bolt, res)  # no device named: the card
        if dcr.device != dev:
            raise RuntimeError(f"DualContourRenderer defaulted to {dcr.device}, not the card")
        cont = dcr.contourer
        calls = dcr.chunks()[0]
        tris, counts = run(f"DC bolt@{resdiv}", ("dc_mesh",), dcr.render)
        exactly(f"DC bolt@{resdiv}", counts, {"dc_mesh": len(calls)})
        if len(tris) != golden:
            raise RuntimeError(f"DC bolt@{resdiv}: {len(tris)} triangles, golden {golden}")
        dc_tris[resdiv] = tris
        origin, shape, k0, n_own = calls[-1]

        def k5_call(origin=origin, shape=shape, k0=k0, n_own=n_own, res=dcr.res, cont=cont):
            return dc_emit.dc_mesh(bolt, origin, res, shape, dev, cont.norm_step,
                                   cont.sqrt_lambda, k0, n_own)

        _, before_fetch = synchronising(k5_call)
        if len(before_fetch) != 1:
            raise RuntimeError(f"DC bolt@{resdiv}: a K5 call should synchronise once, at its "
                               f"count read: {before_fetch}")
        on_card = dc_card.get(f"dc bolt@{resdiv}")

        def sdf_to_stl(res=res):
            buf = io.BytesIO()
            render.write_binary_stl(buf, DualContourRenderer(bolt, res).render())
            return buf.getbuffer().nbytes

        (nbytes, ms), counts = run(f"DC bolt@{resdiv} SDF->STL, median of seven",
                                   ("dc_mesh",), lambda: host_ms(sdf_to_stl, 7))
        row = stages.measure(lambda c, res=res: stages.dc(DualContourRenderer(bolt, res), c),
                             golden, 7)
        e2e[f"dc bolt@{resdiv}"] = ms
        per_render[f"dc bolt@{resdiv}"] = {"dc_mesh": len(calls)}
        if on_card is not None:
            per_render[f"dc bolt@{resdiv}"]["on_the_card_per_k5_call"] = on_card
        dc_slice[f"bolt@{resdiv}"] = {"sdf_to_stl_ms": ms, "stl_bytes": nbytes,
                                      "k5_launches": len(calls),
                                      "synchronising_before_fetch": len(before_fetch), **row}
        log(f"phase 3: DC bolt resdiv {resdiv}: {len(tris)} triangles (golden {golden}), "
            f"{len(calls)} K5 launch{'es' if len(calls) > 1 else ''} (one a chunk), one "
            f"synchronising call in a K5 call; SDF->STL warm median {ms:.2f} ms; by stage "
            + ", ".join(f"{k} {v:.3f}" for k, v in row["stages_ms"].items())
            + f" (total {row['total_ms']:.3f}), device {row['device_ms']:.3f} ms of "
            f"{row['profiled_wall_ms']:.3f}, idle {row['idle_share']:.3f}, fetch "
            f"{row['fetch_mb']:.2f} MB  [{card}]")
    res256 = bolt.bounds().diagonal() / 256
    host, counts = run("DC bolt@256 host_qef=True", ("dc_mesh",),
                       lambda: DualContourRenderer(bolt, res256, host_qef=True).render())
    if len(host) != DC_GOLDENS[0][1] or np.abs(host - dc_tris[256]).max() >= 1e-3 * res256:
        raise RuntimeError(f"DC bolt@256 host_qef: {len(host)} triangles, or farther than "
                           "1e-3 * res from the device QEF")
    log(f"phase 3: DC bolt resdiv 256 through host_qef=True: {len(host)} triangles, max "
        f"|d| from the device QEF {np.abs(host - dc_tris[256]).max() / res256:.3g} * res")
    del host
    res512 = bolt.bounds().diagonal() / 512
    saved = DualContourRenderer.mono_voxels
    DualContourRenderer.mono_voxels = 1 << 40
    try:
        whole, counts = run("DC bolt@512 as one whole grid", ("dc_mesh",),
                            lambda: DualContourRenderer(bolt, res512).render())
    finally:
        DualContourRenderer.mono_voxels = saved
    exactly("DC bolt@512 whole grid", counts, {"dc_mesh": 1})
    if not np.array_equal(whole, dc_tris[512]):
        raise RuntimeError("DC bolt@512: the chunk route differs from the whole-grid render")
    log(f"phase 3: DC bolt resdiv 512: the chunk route's {len(whole)} triangles equal the "
        "whole-grid render's bit for bit")
    del whole, dc_tris

    # the DC edit loop: the pinned part of the JAX package's
    # test_dc_parametric_edit_zero_recompile, the boss's radius an edit
    b = Builder()
    boss = b.new_cylinder(0.45, 1.2, 0.05)
    body = b.smooth_union(0.1, b.new_box(1.6, 1.0, 0.5, 0.05), boss)
    pinned = with_bounds(body, Box([-1.2, -0.8, -0.9], [1.2, 0.8, 0.9]))
    first, _ = run("DC edit loop: the first parametric render", ("dc_mesh_param",),
                   lambda: DualContourRenderer(pinned, 0.06).render(parametric=True))
    built = (dict(_build.COUNTS), len(kernels._libs))
    sizes, edit_ms = [len(first)], []
    for r in (0.3, 0.35, 0.4):
        t0 = time.perf_counter()
        pinned.rebind({boss: {"r": r}})
        tris, counts = run(f"DC edit loop: r = {r}", ("dc_mesh_param",),
                           lambda: DualContourRenderer(pinned, 0.06).render(parametric=True))
        edit_ms.append((time.perf_counter() - t0) * 1e3)
        exactly("DC edit loop", counts, {"dc_mesh_param": 1})
        if (dict(_build.COUNTS), len(kernels._libs)) != built:
            raise RuntimeError(f"DC edit loop: an edit built or loaded a library: "
                               f"{_build.COUNTS}, {len(kernels._libs)} libraries, were {built}")
        baked = DualContourRenderer(pinned, 0.06).render()
        built = (dict(_build.COUNTS), len(kernels._libs))  # the baked render built one
        if tris.shape != baked.shape or np.abs(tris - baked).max(initial=0) > 1e-6:
            raise RuntimeError(f"DC edit loop, r = {r}: the parametric mesh differs from the "
                               "baked render of the edited tree")
        sizes.append(len(tris))
    if len(set(sizes)) != len(sizes):
        raise RuntimeError(f"DC edit loop: an edit did not change the mesh: {sizes}")
    per_render["dc parametric edit"] = {"dc_mesh_param": 1, "on_the_card_per_k5_call":
                                        dc_card["dc parametric edit"]}
    dc_slice["edit loop"] = {"edit_to_mesh_ms": edit_ms, "triangles": sizes}
    log(f"phase 3: DC edit loop: 3 rebinds, 0 compiler runs and 0 libraries loaded by the "
        f"parametric renders, triangles {sizes}, each mesh equal to the baked render of the "
        f"edited tree within 1e-6; edit to mesh {', '.join(f'{t:.2f}' for t in edit_ms)} ms  "
        f"[{card}]")

    # --- the pruned slice: PrunedRenderer on the default device ------------
    goldens[("flange", 1000)] = flagships.GOLDEN_FLANGE_1000_TRIS
    pruned_slice = {}
    for name, resdiv in PRUNED_GRIDS:
        tree, golden = trees[name], goldens[(name, resdiv)]
        res = tree.bounds().diagonal() / resdiv
        pr = PrunedRenderer(tree, res)  # no device named: the card
        if pr.device != dev:
            raise RuntimeError(f"PrunedRenderer defaulted to {pr.device}, not the card")
        (verts, tri), counts = run(f"pruned {name}@{resdiv}", PRUNED_PATH,
                                   lambda: pr.render_compact())
        batches = pr.batches
        exactly(f"pruned {name}@{resdiv}", counts,
                {"tile_prune": 1, **{k: batches for k in PRUNED_PATH[1:]}})
        if pr.fallbacks:
            raise RuntimeError(f"pruned {name}@{resdiv}: render_compact fell back")
        stats = {"tiles": pr.tx * pr.ty * pr.tz, "kept": pr.kept, "batches": batches,
                 "evaluations": pr.evaluations(), "total_pruned": pr.total_pruned(),
                 "dense_corners": math.prod(FlatRenderer(tree, res, dev).shape())}
        # the render's counts against the plain coarse pass at its coarse grid
        _, pcount = gk.coarse_keep_plain(tree, pr.origin, pr.res, pr.S, (pr.tz, pr.ty, pr.tx),
                                         dev)
        n_plain, corners = int(pcount), (pr.S + 1) ** 3
        want = {"kept": n_plain, "batches": -(-n_plain // pr.tiles_per_batch),
                "evaluations": stats["tiles"] + n_plain * corners,
                "total_pruned": (stats["tiles"] - n_plain) * corners}
        if {k: stats[k] for k in want} != want:
            raise RuntimeError(f"pruned {name}@{resdiv}: the render's counts "
                               f"{ {k: stats[k] for k in want} } are not the plain coarse "
                               f"pass's {want}")
        payload, syncs = synchronising(lambda: PrunedRenderer(tree, res).compact_payload())
        fr = FlatRenderer(tree, res, dev)
        dense = compact_field_render(tree, fr.origin, fr.res, fr.shape(), dev)
        same_dense = all(np.array_equal(a, b) for a, b in zip(payload, dense))
        missing = np.setdiff1d(dense[0], payload[0])
        held_to = "the dense payload"
        if not same_dense:  # a field that is not 1-Lipschitz: the prune dropped cubes
            plain = pruned_payload_plain(tree, res, dev)
            if not all(np.array_equal(a, b) for a, b in zip(payload, plain)):
                raise RuntimeError(f"pruned {name}@{resdiv}: the payload differs from the dense "
                                   "one and from the plain pruned version")
            held_to = (f"the plain pruned version (NOT the dense payload: {len(missing)} active "
                       f"cubes pruned, ids {missing[:8].tolist()}; "
                       f"{len(np.setdiff1d(payload[0], dense[0]))} extra)")
            del plain
        if len(syncs) != 2 + 4 * batches:
            raise RuntimeError(f"pruned {name}@{resdiv}: {len(syncs)} synchronising calls in "
                               f"compact_payload, not 2 + 4 a batch: {syncs}")
        if same_dense and len(tri) != golden:
            raise RuntimeError(f"pruned {name}@{resdiv}: {len(tri)} triangles, golden {golden}")
        del payload, dense
        # warm SDF->STL in turns with the dense compact render: dense, pruned
        dense_ms, _, _ = cli.bench_part(tree, resdiv, golden, 5, dev, "compact")
        ms, ntris, all_ms = cli.bench_part(tree, resdiv, len(tri), 5, dev, "pruned")
        reading = device_reading(lambda: PrunedRenderer(tree, res).render_compact())
        dense_reading = device_reading(lambda: FlatRenderer(tree, res, dev).render_compact())
        e2e[f"pruned {name}@{resdiv}"] = ms
        per_render[f"pruned {name}@{resdiv}"] = {k: n for k, n in counts.items() if n}
        pruned_slice[f"{name}@{resdiv}"] = {
            **stats, "triangles": len(tri), "golden": golden, "equal_to": held_to,
            "synchronising_calls": len(syncs),
            "sdf_to_stl_ms": ms, "runs_ms": all_ms, "dense_sdf_to_stl_ms": dense_ms,
            "device": reading, "dense_device": dense_reading}
        log(f"phase 3: pruned {name} resdiv {resdiv}: {len(tri)} triangles (golden {golden}); "
            f"payload (ids, cases, t) equal to {held_to}; {pr.kept} of {stats['tiles']} tiles "
            f"kept, {batches} batch{'es' if batches > 1 else ''}, evaluations "
            f"{stats['evaluations']} (dense {stats['dense_corners']}), total_pruned "
            f"{stats['total_pruned']} (kept, batches, evaluations and total_pruned those of the "
            f"plain coarse pass); launches {per_render[f'pruned {name}@{resdiv}']}; "
            f"synchronising calls in compact_payload {len(syncs)} (the mask's one fetch, the "
            f"tile list's upload, then K3's count read and three fetches a batch); "
            f"SDF->STL warm median {ms:.2f} ms (runs {', '.join(f'{t:.2f}' for t in all_ms)}), "
            f"dense compact {dense_ms:.2f} in turns; on the card "
            f"{None if reading is None else round(reading['device_ms'], 4)} ms (dense "
            f"{None if dense_reading is None else round(dense_reading['device_ms'], 4)})  "
            f"[{card}]")
        del verts, tri
    torch.cuda.empty_cache()

    # the soup: read_triangles' batches, render() == FlatRenderer.render() as rows
    def rows(tris):
        r = np.ascontiguousarray(tris.reshape(-1, 9))
        return r[np.lexsort(r.T[::-1])]

    soup_path = ("tile_prune", "tile_atlas", "compact_active", "emit_soup")
    for name, resdiv in (("flange", 400), ("showerhead", 350)):
        tree = trees[name]
        res = tree.bounds().diagonal() / resdiv
        pr = PrunedRenderer(tree, res)
        soup, counts = run(f"pruned render() {name}@{resdiv}", soup_path, pr.render)
        exactly(f"pruned render() {name}@{resdiv}", counts,
                {"tile_prune": 1, **{k: pr.batches for k in soup_path[1:]}})
        per_render[f"pruned soup {name}@{resdiv}"] = {k: n for k, n in counts.items() if n}
        flat = FlatRenderer(tree, res, dev).render()
        if len(soup) != goldens[(name, resdiv)] or not np.array_equal(rows(soup), rows(flat)):
            raise RuntimeError(f"pruned render() {name}@{resdiv}: {len(soup)} triangles, not "
                               "the flat soup's rows")
        stream = PrunedRenderer(tree, res)
        batches = list(stream.read_triangles())
        if len(batches) != -(-stream.kept // stream.tiles_per_batch) \
                or not np.array_equal(np.concatenate(batches), soup):
            raise RuntimeError(f"read_triangles {name}@{resdiv}: {len(batches)} batches of "
                               f"{stream.kept} tiles, or not the render's soup")
        log(f"phase 3: pruned render() {name}@{resdiv}: {len(soup)} triangles, equal to "
            f"FlatRenderer.render() as sorted rows bit for bit; read_triangles yields "
            f"{len(batches)} batches ({stream.kept} kept tiles, {stream.tiles_per_batch} a "
            f"batch), launches {per_render[f'pruned soup {name}@{resdiv}']}")
        del soup, flat, batches

    # the pruned edit loop: the flange pinned by with_bounds, K6cp and K6ap
    pinned, edits = edit_case(1.2, 0.6, 0.04)
    ppr = PrunedRenderer(pinned, res400)
    first, _ = run("pruned edit loop: the first parametric render", PRUNED_PARAM_PATH,
                   lambda: ppr.render_compact(parametric=True))
    dense_fr = FlatRenderer(pinned, res400, dev)
    if not same_mesh(first, dense_fr.render_compact(parametric=True)):
        raise RuntimeError("pruned edit loop: the first render differs from the dense one")
    built = (dict(_build.COUNTS), len(kernels._libs))
    sizes, loop_ms = [len(first[1])], []
    for what, edit in edits:
        t0 = time.perf_counter()
        pinned.rebind(edit)
        mesh, counts = run(f"pruned edit loop: {what}", PRUNED_PARAM_PATH,
                           lambda: ppr.render_compact(parametric=True))
        loop_ms.append((time.perf_counter() - t0) * 1e3)
        exactly("pruned edit loop", counts,
                {"tile_prune_param": 1, **{k: ppr.batches for k in PRUNED_PARAM_PATH[1:]}})
        dense = dense_fr.render_compact(parametric=True)
        if (dict(_build.COUNTS), len(kernels._libs)) != built:
            raise RuntimeError(f"pruned edit loop: an edit built or loaded a library: "
                               f"{_build.COUNTS}, {len(kernels._libs)} libraries, were {built}")
        if not same_mesh(mesh, dense) or ppr.fallbacks:
            raise RuntimeError(f"pruned edit loop, {what}: the mesh differs from the dense "
                               "parametric render of the edited tree")
        sizes.append(len(mesh[1]))
    if len(set(sizes)) != len(sizes):
        raise RuntimeError(f"pruned edit loop: an edit did not change the mesh: {sizes}")
    per_render["pruned parametric edit"] = {k: n for k, n in counts.items() if n}
    pruned_slice["edit loop flange@400"] = {"edit_to_mesh_ms": loop_ms, "triangles": sizes}
    log(f"phase 3: pruned edit loop flange@400 pinned: {len(edits)} rebinds, 0 compiler runs "
        f"and 0 libraries loaded, triangles {sizes}, each mesh equal to the dense parametric "
        f"render of the edited tree; edit to mesh {', '.join(f'{t:.2f}' for t in loop_ms)} ms  "
        f"[{card}]")

    # the raymarcher's path at full width, on the default device
    rm_slice, rm_per_frame = raymarch_paths(rm_parts, rm_refs, dev, card, run, exactly)
    per_render.update(rm_per_frame)

    log(f"phase 4: kernel launches over the paths: {launches}")

    fr = FlatRenderer(f800, res800, dev)
    payload = compact_field_render(f800, fr.origin, fr.res, fr.shape(), dev)
    args = (*payload, fr.nx, fr.ny, fr.nz, fr.origin, fr.res)
    t0 = time.perf_counter()
    v_nat, tri_nat = native.mc_decode(*args)
    nat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    v_np, tri_np = native.mc_decode_plain(*args)
    np_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(tri_nat, tri_np) and np.array_equal(v_nat, v_np)):
        raise RuntimeError("threaded native mc_decode differs from mc_decode_plain")
    log(f"decode pin: native mc_decode ({os.cpu_count()} host cores) == numpy "
        f"mc_decode_plain bit for bit on flange 800 ({len(tri_nat)} triangles); "
        f"{nat_ms:.1f} ms vs {np_ms:.1f} ms")

    # each kernel's row at one main-path size: the MC kernels and K1, K2 at
    # flange 400, KP at the flange's 2^20 points, K2-2D at the plant pot
    t400 = times["flange@400"]
    rows = {name: t400[name] for name, _, _ in KERNELS if name in t400}
    rows["point_eval"] = times[f"KP flange N={n_points}"]["point_eval"]
    rows["grid_eval_2d"] = times["K2-2D plantpot 1080x1080"]["grid_eval_2d"]
    rows["point_eval_param"] = times[f"KPp flange N={n_points}"]["point_eval_param"]
    rows.update(times["DC bolt@256"])
    rows.update(times["pruned flange@400"])
    rows.update(times["raymarch flange 512"])
    line = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": rows[name]["ms"],
            "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"],
            "bound_by": rows[name]["bound_by"],
            "library_ms": rows[name]["library_ms"],
            "share": rows[name]["share"],
            "launches_per_render": {
                **{path: per_render[f"{path} flange@400"].get(name, 0)
                   for path in ("compact", "soup", "indexed", "compact parametric", "pruned",
                                "pruned soup")},
                **{path: per_render[path].get(name, 0)
                   for path in ("dc bolt@256", "dc bolt@512", "dc parametric edit",
                                "pruned parametric edit", "raymarch_image aa1",
                                "raymarch_image aa3", "viewer drag", "viewer full", "ui frame",
                                "viewer set_param")},
            },
            **({"baked_ms": rows[name]["baked_ms"],
                "by_pointer_ms": rows[name].get("by_pointer_ms")}
               if name.endswith("_param") else {}),
            **({"tile_mode": {k: v for k, v in rows["emit_soup_tiles"].items()
                              if k != "on_device"}} if name == "emit_soup" else {}),
            "on_device_per_call": rows[name]["on_device"],
        }
        for name, source, replaces in KERNELS
    ]
    log(json.dumps({"build_s": build_s, "device_ms": times, "sdf_to_stl_ms": e2e,
                    "launches_per_render": per_render, "point_and_2d_slice": slice_ms,
                    "parametric_slice": param_ms, "dc_slice": dc_slice,
                    "pruned_slice": pruned_slice, "pruned_kernels_differing": pruned_diff,
                    "pruned_kernels_differing_full_width": pruned_full_diff,
                    "parametric_floats_differing_from_baked": differing,
                    "raymarch_kernels": rm_times, "raymarch_slice": rm_slice,
                    "raymarch_pixels_differing_from_plain": rm_differing}))
    log(json.dumps({"kernels": line}))
    finish(card)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        rc = 1
    sys.exit(rc)
