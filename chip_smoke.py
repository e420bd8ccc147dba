#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path (gatling_tpu_torch) the way a user does and
fails, with a non-zero exit, if any phase fails:

1. device: a CUDA card must be present (there is no CPU path);
2. build: the kernels K1 (resident bounce), K2 (two-level walk bounce),
   K3 (split trace) and K4 (split shade, with its own texture taps; its
   taps alone K4t; both also in FLT instances over a float texel pool) are
   built from gatling_tpu_torch/csrc/bounce.cu (in fifteen nvcc parts), K5-K8 and
   B1/B2 (the wavefront's trace) from csrc/trace.cu and the probes P1/P2 from
   csrc/probes.cu, every nvcc run at once, and with them the native host
   library from csrc/gatling_native.cpp (g++: the threaded-BVH build,
   lz4, the image codecs' loops); one line a kernel instance of ptxas'
   registers, stack and spills;
3. K1 against its plain twin (ops/bounce_ref.py) on the card, through
   the wrapper the main path calls (ops/bounce.py bounce_step), on the ray
   waves the main path builds: Cornell 1200x1200 x 2 samples (2.88M rays,
   NEE off and on) and Lights.Analytic 96x96 x 24 samples, at bounce 0 and
   at bounce 4 from a state the twin stepped; then both timed on the
   Cornell waves. K1, K3 and K4 walk a BVH over the resident table
   (ops/bvh.py TriBvh) where the twins test every triangle; their bound is
   the walk's work (bounce_ref.resident_work: its slab and triangle tests,
   the NEE shadow rays' included), the brute-force bound beside it;
3b. K2 against its twin the same way, on the sphere_field wave (512x512 x
   4 samples, 1,048,576 rays, in 32x32 pixel tiles), NEE off and on,
   through the instanced tables (gi's route) and the flattened ones; and
   the Cornell box in clustered tables held against K1's resident step;
   then K2 and the twin timed on the wave as generated and after the
   coherence sort, and K2 at bounces 1-5 of the frame with and without
   the sort. K2, K3 and K4 walk a BVH inside each cluster (ops/bvh.py
   ClusterBvh); their bound is the walk's counted work
   (bounce_ref.cluster_work: TLAS, cluster-box and tree slab tests and
   triangle tests, the NEE shadow rays' included), the cluster floor (the
   brute-force loop's 128 triangle tests a cluster box entered) beside it;
4. full-size renders through gatling_tpu_torch.gi, as the CLI renders:
   Cornell 1200x1200 at 16 spp and 8 bounces, the same with NEE and a rect
   light, and Lights.Analytic at its authored settings, each checked;
4b. sphere_field (294,916 triangles) at the JAX bench's settings, 512x512,
   4 spp, 6 bounces, NEE off and on, checked, and the same frame through
   the flattened tables, which must agree;
4c. a transform edit of one sphere group: the refit tables equal a fresh
   build;
4d. the textured interior (92,492 triangles, every material a UsdUVTexture)
   through gi.render at the JAX bench's settings, 512x512, 4 spp, 6
   bounces, NEE on: checked (finite, non-negative, per-material means
   against a frame of the texture means), the textureLodBounces=2 frame
   and a normal-mapped frame against it, first and warm frame times; the
   textured Cornell box at 1200x1200, 16 spp, 8 bounces; interior_taps
   (sRGB, clamp, mirror and black wraps, metallic and roughness from the
   b and g channels); each textured frame calls the texture stage
   (ops/split_ref.py material_rows) 0 times;
3c. then K3 and K4 against their twins (ops/split_ref.py; K4's is the
   texture stage, then shade_ref), through the wrappers the main path
   calls (ops/bounce.py trace_step, shade_step), on the tables gi.render
   built for 4d's frames: the interior's first wave (512x512 x 4 samples,
   1,048,576 rays), plain and normal-mapped, on gi's instanced tables and
   on the flattened tables of the same geometry, interior_taps', NEE off
   and on, at bounces 0 and 4, and the textured Cornell box's wave
   (1200x1200 x 2 samples, resident tables): rows 12-15 bit-equal on
   every ray, and K4's taps alone (ops/bounce.py tap_rows) bit-equal to
   the texture stage's on every hit ray; then both, their twins and the
   texture stage K4's taps replace timed; K4's bound counts its state and
   hit rows, the distinct texels its taps read and its NEE shadow walk's
   counted work;
5. progressive accumulation over one scene (sampleOffset 16 -> 32 -> 48);
4e. the wavefront integrator through gi.render, every AOV bound (the ids
   in int32 buffers): cornell_aovs (the Cornell box and the bench's rect
   light, 1200x1200, 16 spp, 8 bounces, NEE) and interior_aovs_small
   (interior(detail=1), 3,840 triangles, 512x512, 4 spp, 6 bounces, NEE,
   textured), a first and a warm frame each, COLOR's Cornell checks,
   ids in range, unit normals, K5 and K6 launched and K1-K4 not; then
   Mesh.PrimvarInterpolation and Render.AOVs on the card and through the
   twins on the CPU, the same samples: ids equal on 99.9 % of pixels,
   COLOR means within 1 %;
3d. then K5-K8 against their twins (ops/trace_ref.py), through the
   wrappers (ops/trace.py), on the waves 4e's frames handed the tracer
   (sample 0, bounces 0 and 2: the closest-hit waves, 1,440,000 and
   262,144 rays, and the NEE shadow waves) and the tables gi built: tri,
   t, u, v bit-equal and the occlusion flags equal on every ray, K7's
   triangle K5's on 99 % of rays; each kernel and twin timed, K5's and
   K6's bounds from their BVH walks' work (trace_ref.matrix_work,
   occluded_work, whose flags must equal the twin's) beside the
   brute-force ones; every bound also at one FP32 instruction an
   operation (33.45e12/s: the kernels build with -fmad=false); K7 and K8
   also on the first 8192 triangles of interior(detail=2), more rows than
   they hold at once (their streamed path): its camera wave at 512x512 and
   shadow rays from its hits to its lights, bit-equal, with their layout
   (rays a K7 thread, lanes a K8 shadow ray, rows a chunk) and K8's tests
   past each ray's first occluder; after 4f, the same on
   cornell_cutout_aovs' shadow-hop waves (bounces 0 and 2, recorded by
   wrapping render/integrator.py _trace_occluded_cutout);
4l. the wavefront above 8192 triangles, on the threaded BVH tracer (B1
   closest hits, B2 shadow rays; gi builds the tree at the first
   wavefront frame), every AOV bound: interior_aovs (the interior at full
   detail, 92,492 triangles) and sphere_field_aovs (294,916, flattened
   into the soup), 512x512, 4 spp, 6 bounces, NEE, the tree's build time
   on the host, a first and a warm frame, B1 and B2 launched and K1-K8
   not, the AOV checks; interior_dynamic (the interior at full detail,
   its pots' emission Materials.MtlxViewDirection's view-dependent graph,
   its crates a two-sided MDL material: the dynamic inputs and the
   backface rows, COLOR, 512x512, 4 spp, 6 bounces, NEE), its warm frame
   and checks, the dynamic expression on the card against the CPU, and
   the scene at 32x32 on the card against the CPU twins, the same samples;
   sphere_field_aovs' frame is recorded twice: each wave's rays, live
   counts and B1's hits or B2's flags must be bit-equal;
3i. then B1 and B2 against their twins (ops/trace_ref.py, the JAX walk in
   lockstep) on 4l's recorded waves (interior_aovs bounces 0 and 2,
   sphere_field_aovs bounce 0, closest and shadow rays, 262,144 rays
   each): t, tri, u, v and the flags bit-equal on every ray; each timed
   with its bound (the walk's counted slab and triangle tests); and on
   interior_aovs_small's waves over a threaded BVH of its soup, beside K5
   and K6 on the same rays;
4f. the advanced lobes and the cutout through gi.render, a first and a
   warm frame each with the kernels' launches: glass_coated
   (Materials.GlassCoated at the bench's 1200x1200, 16 spp, 8 bounces,
   NEE off and on: K1's advanced branch), cornell_cutout (the Cornell box
   and the bench's rect light, the tall block at opacity 0.5, the short
   one shut out by its opacityThreshold: K1's cutout on camera and shadow
   rays; its first wave's pass rate through the tall block 0.5 +- 0.01),
   sphere_field_lobes (a thick glass, a clearcoated and a half-open sphere
   material, 512x512, 4 spp, 6 bounces, NEE off and on: K2's two
   branches, instanced, and the NEE frame through the flattened tables),
   interior_lobes (an anisotropic open_pbr worktop over its marble, the
   instanced bowls at opacity 0.5: K3's cutout and K4's advanced branch
   with the mesh-tangent frame) and cornell_cutout_aovs (every AOV: the
   wavefront's cutout, K5 for the camera rays and, hop by hop, the shadow
   rays); and Materials.GlassCoated at its own settings against its
   committed reference;
3e. then each branch's kernel against its twin on the waves 4f's frames
   handed it (bounces 0 and 2, recorded by wrapping render/fused.py's
   bounce_step / shade_step) and the tables gi built, the cutout draws
   bit for bit; each timed at bounce 0;
4g. media, bound through the MDL front end, through gi.render, a first and
   a warm frame each with the kernels' launches: glass_tinted (the
   Cornell box, its tall block OmniGlass tinted (0.55, 0.8, 0.95) through
   info:mdl:sourceAsset, the bench's rect light, 1200x1200, 16 spp, 8
   bounces, NEE, mediumStackSize 0: K1's absorption branch; also one frame
   through gatling_tpu_torch.cli on the written .usda), cornell_fog (the
   tall block a written fog.mdl, stack 1: K1's scatter branch; against the
   wavefront's frame of the same samples, the per-channel means within
   FOG_MEAN_TOL), cornell_fog_stack2 (the wavefront's medium stack: K5
   and K6, K1-K4 not launched), sphere_field_volumes (a tinted-glass and a
   fog sphere material, 512x512, 4 spp, 6 bounces: K2's scatter branch,
   NEE off and on, the NEE frame also through the flattened tables, which
   must agree; at stack 0 K2's absorption branch), interior_tinted (the
   interior's instanced bowls in tinted OmniGlass: K3 and K4's absorption
   branch), and the slab of tests/test_volumes.py at 8x8 on the fused
   path, its centre pixel 2 exp(-2 sigma) within 5 % at stack 0 and 1;
3f. then each volume branch against its twin on 4g's recorded waves
   (bounces 0 and 2: rays inside media at 2) and gi's tables: rows 12-15,
   H_HIT and H_MAT bit-equal on every ray, the other rows within
   tolerance on 99.9 %; each timed at bounce 0;
4h. the first-hit AOVs on the fused route (COLOR, NORMAL, ALBEDO, DEPTH and
   TEXCOORDS bound): the Cornell box with the bench's rect light (1200x1200,
   16 spp, 8 bounces, NEE) and the textured interior (512x512, 4 spp, 6
   bounces, NEE), a first and a warm frame each with their launches (one
   sample a wave; bounce 0 peeled through K3, K4's taps alone (tap_rows,
   K4t) and K4), checked (unit normals where hit, ALBEDO in [0, 2], DEPTH
   finite, no call of the texture stage); interior(detail=1) and the
   Cornell box held against the wavefront's first-hit AOVs of the same
   samples: NORMAL, DEPTH and TEXCOORDS within FH_RTOL / FH_ATOL on 99 % of
   the pixels both hit;
4i. camera clipping on the fused route: the Cornell box at 1200x1200, 16
   spp, 8 bounces, the open range, a near plane that cuts the room and a
   far plane that cuts it (tests/test_fused.py:850's ranges and checks),
   the near and far frames against the wavefront's of the same samples:
   the means within MEAN_SIGMAS standard errors of their per-pixel
   differences;
4j. the textured cutout on the fused route: the interior with its bowls'
   opacity a checker mask written at run time (and emitting, so that the
   frame without NEE is lit), 512x512, 4 spp, 6 bounces, NEE off and on: K3
   four times a split bounce (the trace and three re-trace rounds), K4's
   taps three times, K4 once; the first wave's pass rate through the mask
   0.5 +- 0.01; interior(detail=1)'s NEE-off frame against the wavefront's
   (which taps the opacity at every hit), means as in 4i, held at 24 and
   48 bounces (CUTOUT_MEAN_PAIRS; the 6-bounce pairs, at the re-trace's 4
   rounds and at 16, logged: the wavefront spends a bounce on each pass
   through the mask);
3g. then tap_rows on the waves of 4h and 4j against tap_rows_ref, every
   row (the opacity's included) bit-equal on every hit ray; K3 and K4 on
   4i's clipped peel waves against their twins as 3c holds them; K3 on
   4j's masked re-trace waves; each timed, with its bound (tap_rows: the
   hit rows its outputs depend on, the distinct texels touched, 12 rows
   written);
4k. dome lights and float texel pools through gi.render, a first and a
   warm frame each with their launches: cornell_dome (the Cornell box,
   open towards -y, under a 2048x1024 half EXR sky written at run time by
   the port's encode_exr: a vertical gradient and a 16x16-texel sun of
   5e3; 1200x1200, 16 spp, 8 bounces, NEE off and on, camera-visible and
   not: K1; the invisible frame darker only on pixels whose camera rays
   missed), once through gatling_tpu_torch.cli on the .usda that holds
   the DomeLight prim (its PNG within one code of the gi frame's),
   sphere_field_dome (a 4096x2048 float32 sky, rotated 30 degrees about
   the up axis, emission (1.5, 1.4, 1.3); 512x512, 4 spp, 6 bounces, NEE:
   K2), cornell_aovs_dome (every AOV under the cornell_dome sky: the
   wavefront's K5/K6 and the dome on the miss; the fused NEE frame's mean
   against it within MEAN_SIGMAS), interior_hdr_textured (the interior
   with its floor a 2048x2048 EXR reaching 4: the whole pool float; K3 and
   K4's FLT instance, no texture stage) and interior_hdr_first_hit (its
   first-hit AOVs: K4t's FLT instance); the dome pass (render/fused.py
   dome_pass) on the card against its CPU run on three frames' final
   states, 99.9 % of rays within 1e-4, with its device time;
3h. then K3 and K4's FLT instances against their twins on 4k's recorded
   waves (interior_hdr_textured on gi's instanced tables, and a Cornell
   box with an EXR checker on every base colour on resident ones; bounces
   0 and 2): rows 12-15, H_HIT and H_MAT bit-equal on every ray; K4t's
   FLT instance on interior_hdr_first_hit's peel wave, and with
   TAP_OPACITY over the float floor texture, bit-equal to tap_rows_ref on
   every hit ray; each timed with its bound (16 bytes a distinct float
   texel);
4m. USD content (phase_content): 16 skinned figures (6,144 triangles
   each; 24-joint chains, 4 influences a vertex, animations sampled at
   frames 1-24, a blend shape) on a textured ground, MaterialX nodes
   authored in USD (a checkerboard, a noise roughness, a two-texture
   multiply, a frame-driven emission), written as .usda, parsed, saved as
   a crate file and zipped into a .usdz by the port; the .usdc read back
   equal to the parsed stage within f32 rounding (also in the exporters'
   lz4 layout); cli.render_scene_file of the .usdz at frame 12, 512x512,
   4 spp, 6 bounces, NEE: K3 and K4 over the two-level walk, the
   composites baked into the 8-bit pool; a first frame and two warm ones
   with the host times of the crate read, the skinning, the baking and
   the pool build; the .usdz frame against the .usda frame (CONTENT_RTOL,
   CONTENT_ATOL), the 128x128 frame against the wavefront's (MEAN_SIGMAS);
   a frame-13 render that lowers the animated material alone (its
   emission 13 x in2 exactly, the pool and fused tables kept); then K3 and
   K4 on the bounce-0 wave against their twins, timed with their bounds;
4n. formats (phase_formats): (a) every image fixture of tests/data/imgio
   (JPEG baseline 4:2:0 / 4:2:2 / 4:4:4, with restarts, progressive and
   grey; TGA raw and run-length; TIFF LZW with predictor 2, 16-bit
   Deflate and float; PNG interlaced, 16-bit RGB, 16-bit grey and 1-bit)
   decoded on the card's host, bit-equal to fixtures.npz (Pillow's arrays,
   written where Pillow runs); (b) the textured interior at 512x512, 4
   spp, 6 bounces, NEE, its materials' base colours eight 8-bit fixtures
   of eight formats, bit-equal to the frame whose textures are PNGs of
   the port's decoded codes, K3 and K4 on its bounce-0 wave against their
   twins; (c) the interior with the 16-bit grey PNG as every material's
   roughness (a float pool): 6 K4f launches a frame, K3 and K4f on its
   bounce-0 wave against their twins, its 128x128 frame against the
   wavefront's (MEAN_SIGMAS); (d) the content scene with its 1024^2 ground
   a JPEG written by the port: the ground's decode and the pool build on
   the host, the frame; (e) the threaded BVHs of 4l's interior_aovs and
   sphere_field_aovs, built by the native library, against build_bvh_ref
   array for array, both timed; (f) 4m's crate file in the exporters'
   layout read through the native lz4, every block against the
   pure-Python twin's bytes, both timed; (g) (b)'s interior with its
   textures served by a registered in-memory asset reader, bit-equal to
   (b);
4o. the front ends (phase_front_ends): (a) the Cornell box with the
   bench's rect light made by giCreateRectLight and its setters, rendered
   through the Hydra delegate's render pass (1200x1200, 16 spp, 8 bounces,
   NEE; 64 K1 launches), bit-equal to cli.render_scene_file's frame of the
   file with the same RectLight prim (examples.cornell_rect) and to phase
   4's gi frame, its warm time beside that frame's; (b) the textured
   interior (512x512, 4 spp, 6 bounces, NEE) through the delegate, 6 K3 and
   6 K4, bit-equal to gi's frame; (c) a checkpoint at 1200x1200: 8 spp,
   giSaveCheckpoint, giLoadCheckpoint into a fresh scene, 8 more, bit-equal
   to 16 in one scene, the save and load timed; (d) giDestroyMesh with
   OBJECT_ID bound (the wavefront, K5/K6): the survivors' ids unchanged;
   (e) parallelDevices 2, clamped to the cards present, bit-equal to 1;
   (f) render_fused_sharded on [cuda:0, cuda:0]: two tiles bit-equal to the
   one-device frame, two sample shards within RTOL/ATOL, each timed warm;
   (g) GATLING_VALIDATE=1 on (a)'s frame: the same bits; (h) the husk
   bridge (gatling_tpu_torch/dist/houdini) writing a PNG from a new
   process; (i) sphere_field's meshes registered with and without the
   compression, timed;
4p. the remaining formats (phase_formats2): (a) every fixture of
   tests/data/imgio past 4n's fifteen (BMP, DIB, ICO, CUR, GIF, DDS BC1-BC7
   and raw, PSD, QOI, PPM/PGM/PBM/PFM, 16-bit TGA, palette, CMYK, 4-bit,
   32-bit, planar, fill-order-2, old-LZW, JPEG-compressed and BigTIFF, CMYK,
   YCCK, 4:1:1 and 3x1 JPEG) decoded on the card's host, bit-equal to
   fixtures.npz; (b) the textured interior at 512x512, 4 spp, 6 bounces,
   NEE, its twelve 8-bit slots (ten base colours, two roughnesses) BMP, GIF,
   DDS BC1/BC3/BC7, PSD, QOI, PPM, 16-bit TGA, palette TIFF, JPEG-in-TIFF
   and CMYK JPEG: 6 K3 and 6 K4 a frame, bit-equal to the frame whose
   textures are PNGs of the port's decoded codes, K3 and K4 on its bounce-0
   wave against their twins; (c) the same interior with a 16-bit PGM, a
   PFM and a 1-bit BMP as the roughnesses (a float pool): 6 K4f a frame,
   K3 and K4f on its bounce-0 wave against their twins, its 128x128 frame
   against the wavefront's (MEAN_SIGMAS); (d) the host times of (b)'s and
   (c)'s pool builds; (e) GATLING_FUSED=0 with GATLING_TRACER=brute (the
   plain Moller-Trumbore: no kernel launched, a request, not a fallback)
   and =bvh (B1/B2) on the Cornell box at 64x64;
4q. WebP (phase_webp): (a) every WebP fixture of tests/data/imgio (lossy
   RGB, lossy RGBA with its ALPH chunk, lossless RGB and RGBA, a
   three-frame animation, and 1024^2 lossy RGB, lossy RGBA and lossless
   files) decoded on the card's host, bit-equal to Pillow's array
   (fixtures.npz; the 1024^2 ones by the SHA-256 make_fixtures.py records;
   4n (a) and 4p (a) leave these out); (b) the textured interior at
   512x512, 4 spp, 6 bounces, NEE, its six 8-bit base colours lossy RGB,
   lossy RGBA, lossless RGB, lossless RGBA, the animation's first frame and
   the 1024^2 lossy ground: 6 K3 and 6 K4 a frame, bit-equal to the frame
   whose textures are PNGs of the port's decoded codes, K3 and K4 on its
   bounce-0 wave bit-equal to their twins and timed; (c) the host times of
   (b)'s pool build and of the three 1024^2 decodes;
4r. JPEG 2000 and JPEG's other processes (phase_jpeg2000): (a) every
   fixture of tests/data/imgio they added (JP2 and raw codestreams: 5/3
   lossless, 9/7 with MCT, RGBA with a cdef box, tiled RPCL with
   precincts, a pclr palette, 16-bit grey, the 1024^2 9/7 ground;
   arithmetic sequential and progressive JPEG, a lossless JPEG, a
   block-smoothed progressive one) decoded on the card's host, bit-equal
   to Pillow's array (fixtures.npz; the 1024^2 ground by its SHA-256; 4n
   (a) and 4p (a) leave these out), each decode timed; (b) the textured
   interior at 512x512, 4 spp, 6 bounces, NEE, its nine 8-bit base
   colours those files (the 1024^2 ground among them): 6 K3 and 6 K4 a
   frame, bit-equal to the frame whose textures are PNGs of the port's
   decoded codes, K3 and K4 on its bounce-0 wave bit-equal to their twins
   and timed; (c) the 16-bit grey JPEG 2000 (I;16) as every material's
   roughness (a float pool): 6 K4f a frame, K4f on its bounce-0 wave
   against its twin; (d) the host times of (b)'s and (c)'s pool builds and
   of the 1024^2 decode;
4s. TIFF's codecs and layouts (phase_tiff): (a) every TIFF fixture of
   tests/data/imgio phase 4s added (ZSTD with predictors 2 and 3, LZMA,
   Group 4, Group 3 2D with fill bits, Modified Huffman, ThunderScan, YCbCr
   4:2:0 under LZW, Orientation 6 under LZW, planes of 16-bit RGB, an
   old-style JPEG, 16-bit grey LZMA, a 1024^2 ZSTD ground and Group 4
   stencil) decoded on the card's host, bit-equal to Pillow's array
   (fixtures.npz; the 1024^2 ones by their SHA-256; 4n (a) and 4p (a)
   leave these out), each decode timed; (b) interior_tiff: the textured
   interior at 512x512, 4 spp, 6 bounces, NEE, its ten base colours LZMA
   RGBA, Group 4, Group 3 2D, Modified Huffman, the 1024^2 ZSTD ground (the
   floor), ThunderScan, YCbCr, Orientation 6, planes and old-style JPEG: 6
   K3 and 6 K4 a frame, bit-equal
   to the frame of its _png twin (PNGs of the port's decoded codes), K3
   and K4 on its bounce-0 wave bit-equal to their twins and timed; (c)
   interior_tiff_float: every roughness the float ZSTD (predictor 3) or the
   16-bit grey LZMA file (a float pool): 6 K4f a frame, K4f against its
   twin; (d) the host times of (b)'s and (c)'s pool builds and the median
   of five decodes of each 1024^2 file;
4t. Pillow's legacy plugins (phase_legacy): (a) every fixture of
   tests/data/imgio phase 4t added (PCX with a VGA palette, DCX, BLP2 DXT1,
   BLP1 JPEG, a 1024^2 SGI RLE tile ground, FTEX DXT1, Sun RLE with a
   palette, an ICNS it32 icon with its mask, XPM, IM RGB, SPIDER, FITS -32
   of big- and of little-endian floats and 16, McIdas 16-bit, IM "F" and
   "I;16", FLI, MSP 2, a GIMP brush, an XV thumbnail, XBM) decoded on the
   card's host, bit-equal to Pillow's array (fixtures.npz; the 1024^2
   ground by its SHA-256; 4n (a) and 4p (a) leave these out), each decode
   timed; (b) interior_legacy: the textured
   interior at 512x512, 4 spp, 6 bounces, NEE, its ten 8-bit base colours
   those files (the SGI ground the fifth: /m_floor): 6 K3 and 6 K4 a frame,
   bit-equal to its _png twin (PNGs of the port's decoded codes), K3 and
   K4 on its bounce-0 wave bit-equal to their twins and timed; (c)
   interior_legacy_float: four of those as base colours and the SPIDER,
   FITS (-32, 16), McIdas and IM float files as the roughnesses (a float
   pool; the FITS -32 file's big-endian floats read as Pillow reads them,
   little-endian: NaN and infinite texels among them): 6 K4f a frame,
   bit-equal to its _pfm twin (PFMs of the same floats), K4f on the
   bounce-0 wave bit-equal to its twin, a NaN row agreeing with a NaN
   row, and timed; (d) the host times of (b)'s
   and (c)'s pool builds and the median of five decodes of the 1024^2
   ground;
goldens: the committed scenes tests/test_torch_graphical.py renders, all
   ten, through gatling_tpu_torch.testing.run_graphical_test on the card at
   their own thresholds (Materials.MtlxViewDirection on the wavefront,
   its emission evaluated per hit; Materials.GlassCoated: its reference is a
   wavefront image, the harness renders the port's fused K1, and only the
   error components may miss; 4f holds its wavefront frame to both);
P. the probes P1 (the six layout moves in one launch, a block a move,
   tools/cast_probe.py) and P2 (the one-hot product at TF32, FP32 and
   3xTF32, tools/precision_probe.py) through their entry points, against
   their twins, with torch.matmul's error and time beside P2: P1's launch,
   each P2 mode and torch.matmul (TF32 allowed and not) timed as the device
   time a launch (CUDA events around 200 back-to-back launches queued
   behind a device sleep, over 200), and as one call with its host enqueue
   (P1: the whole run), P2's also as the host's enqueue alone (1,000
   calls, then one synchronize); beside P1 the launch floor, a one-element
   add_'s device time a launch.

Each kernel's launches are counted over one frame of its path through
gi.render (K1: the Cornell frame; K2: sphere_field's, NEE off; K3 and K4:
the interior's; K4t, K4's taps alone: cornell_first_hit's; K5 and K6:
cornell_aovs'; the branches: 4f's and 4g's frames; 4h-4j's, 4m's, 4n's,
4p's, 4q's, 4r's, 4s's and 4t's frames beside K3's, K4's, K4t's and K4f's entries; B1 and B2: interior_aovs', with
sphere_field_aovs' and interior_dynamic's beside; P1/P2: the probes'
run), the counts set to
0 just before it and read just after (K4f and K4tf, the FLT instances:
interior_hdr_textured's and interior_hdr_first_hit's frames). K7 and K8 are on no path (the JAX package's comparison point)
and count 0. The last lines are the card's name and power limit, one JSON
line with the kernels' launch counts, errors, times and bounds, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(HERE, "tests", "data", "cornell.usda")
ANALYTIC = os.path.join(HERE, "tests", "graphical", "Lights.Analytic", "scene.usda")
FULL_RES = 1200  # the bench's Cornell frame
ANALYTIC_RES, ANALYTIC_SPP = 96, 24  # Lights.Analytic's authored settings
RTOL, ATOL, MIN_AGREE = 1e-4, 1e-5, 0.999
SF_RES, SF_SPP, SF_BOUNCES = 512, 4, 6  # the JAX bench's sphere_field settings (bench.py:40-48)
# H100 SXM5 peaks: HBM3 bytes/s, f32 FLOP/s outside the tensor cores, TF32
# on the tensor cores (dense)
HBM_BPS, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
# built with -fmad=false, every f32 multiply and add is one FP32 instruction:
# 128 a clock on each of the 132 SMs at 1.98 GHz, 33.45e12/s (the published
# f32 peak counts a fused multiply-add as two operations)
FP32_INSTR_RATE = 132 * 128 * 1.98e9
TRI_TEST_FLOPS = 30  # one Baldwin-Weber triangle test, counted from the kernels' code
SLAB_FLOPS = 24  # one slab test: 6 subtractions, 6 multiplications, 12 min/max


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bench_rect_light():
    """The NEE bench light: a rect under the Cornell ceiling, emitting down."""
    import numpy as np

    from gatling_tpu_torch.scene.stage import LightDesc

    xf = np.eye(4)
    xf[3, :3] = [0.0, 0.0, 0.9]
    return LightDesc(
        path="/benchlight", light_type="rect", transform=xf,
        params=dict(intensity=4.0, exposure=0.0,
                    color=np.array([1.0, 0.9, 0.8], np.float32),
                    normalize=False, diffuse=1.0, specular=1.0,
                    enableColorTemperature=False, colorTemperature=6500.0,
                    width=0.8, height=0.6))


def scene_tables(path, extra_lights, device, resident_max=4096):
    """Fused tables and camera of a scene file, built by the port."""
    from gatling_tpu_torch.ops.bounce import build_fused_scene
    from gatling_tpu_torch.ops.geometry import build_geometry
    from gatling_tpu_torch.render.lights import build_light_arrays
    from gatling_tpu_torch.render.material import build_material_table, lower_material
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(path)
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    geom = build_geometry(desc.meshes, midx)
    rows = [lower_material(desc.materials.get(p) if p else None) for p in midx]
    lights = [l for l in desc.lights if l.light_type != "dome"] + list(extra_lights)
    fs, _static = build_fused_scene(geom, build_material_table(rows),
                                    build_light_arrays(lights), device, resident_max)
    return fs, desc.first_camera()


def wave_state(cam_desc, w, h, samples, device, tiled=False):
    """Packed state of the main path's first ray wave over a w x h frame:
    `samples` jittered camera samples of every pixel, with the pixel and
    sample indices render_pixels_fused gives them (pixels in 32x32 tiles
    when `tiled`, as it orders them for a clustered scene)."""
    import torch

    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops.bounce import pack_state
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays
    from gatling_tpu_torch.render.fused import tile_order

    cam = camera_uniforms(cam_desc, False, device)
    pix = torch.arange(w * h, device=device)
    if tiled:
        pix = torch.as_tensor(tile_order(w, h), device=device)
    pix = pix.repeat(samples)
    sidx = torch.arange(samples, device=device).repeat_interleave(w * h)
    o, d, rng = generate_primary_rays(cam, w, h, pix % w, pix // w, smp.rng_init(pix, sidx),
                                      True, True, False)
    return pack_state(o, d, rng, pix.numel())


def params_row(bounce: int, device):
    import torch

    from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms
    from gatling_tpu_torch.ops.bounce import make_params
    from gatling_tpu_torch.render.camera import CameraUniforms

    cam = CameraUniforms(None, None, None, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    uni = Uniforms(cam, 0, 1.0, 10.0, 0.95, 1.0, 1.0, 7)
    return make_params(RenderConfig(1, 1), uni, bounce + 1, device)[bounce].contiguous()


def compare(kernel_state, twin_state):
    """Mismatch counts of the kernel's state against the twin's: rows 12-15
    bit for bit, rows 0-11 at rtol/atol, a NaN agreeing with a NaN alone
    (a NaN texel's ray: both shade it to NaN); returns (bad_bits, outside,
    n, max_abs_err over rows 0-11, NaN where one side alone is NaN)."""
    import torch

    k, t = kernel_state, twin_state
    bad_bits = int((k[12:].view(torch.int32) != t[12:].view(torch.int32)).any(dim=0).sum())
    close = torch.isclose(k[:12], t[:12], rtol=RTOL, atol=ATOL, equal_nan=True).all(dim=0)
    outside = int((~close).sum())
    both_nan = torch.isnan(k[:12]) & torch.isnan(t[:12])
    max_err = float(torch.where(both_nan, 0.0, (k[:12] - t[:12]).abs()).max())
    return bad_bits, outside, k.shape[1], max_err


def k1_bound_ms(state, fs) -> float:
    """The brute-force bound of one K1 launch on `state`: its 16 state rows
    read and written once and the tables read once, at the HBM rate,
    against every alive ray's test of every triangle at the f32 rate (the
    twin's search)."""
    alive = int((state[13] > 0.5).sum())
    nbytes = 2 * state.numel() * 4 + 4 * (fs.tris.numel() + fs.mats.numel() + fs.lights.numel())
    return _bound(nbytes, alive * fs.tris.shape[0] * TRI_TEST_FLOPS)


def traced_shadow_rays(run):
    """The NEE shadow rays a twin traces while `run()` runs (the occluder of
    ops/bounce_ref.py and ops/split_ref.py wrapped): a list of (origins
    [n, 3], directions [n, 3], distances [n], the salted cutout words or
    None)."""
    import torch

    from gatling_tpu_torch.ops import bounce_ref, split_ref

    rays, real = [], bounce_ref.occluder

    def occluder(tris, walk, cutout=False):
        fn = real(tris, walk, cutout)

        def traced(o, d, dist, key):
            rays.append((torch.stack(o, 1), torch.stack(d, 1), dist, key if cutout else None))
            return fn(o, d, dist, key)
        return traced

    bounce_ref.occluder = split_ref.occluder = occluder
    try:
        run()
    finally:
        bounce_ref.occluder = split_ref.occluder = real
    return rays


def nee_shadow_rays(p, fs, state, nee):
    """The NEE shadow rays of one bounce of `state` over fs, as the twin
    traces them (traced_shadow_rays)."""
    return traced_shadow_rays(lambda: bounce_twin(p, fs, state.clone(), nee)) if nee else []


def shadow_walk_work(fs, rays) -> tuple[int, ...]:
    """The counted work of the any-hit walks of shadow rays `rays`
    (traced_shadow_rays) over fs: (slab, triangle) tests through the
    resident tree (bounce_ref.resident_work), or the two-level walk's
    (TLAS and entry, cluster-box, tree slab, triangle) tests
    (bounce_ref.cluster_work)."""
    import torch

    from gatling_tpu_torch.ops.bounce_ref import cluster_work, resident_work

    work = [0, 0] if fs.walk is None else [0, 0, 0, 0]
    for so, sd, dist, skey in rays:
        ones = torch.ones_like(dist, dtype=torch.bool)
        if fs.walk is None:
            counts = resident_work(fs.bvh, so, sd, ones, 0.0, skey, dist=dist)[-2:]
        else:
            counts = cluster_work(fs.walk, so, sd, ones, 0.0, skey, dist=dist)[2:]
        work = [w + int(c.sum()) for w, c in zip(work, counts)]
    return tuple(work)


def resident_walk_work(p, fs, state, nee: bool) -> tuple[int, int]:
    """(slab tests, triangle tests) of the BVH walks of one resident K1
    (K3: NEE off) launch on `state`, from bounce_ref.resident_work:
    every alive ray's closest-hit walk (its cutout words as the kernel's)
    and, with NEE, the any-hit walk of each shadow ray the twin traces."""
    from gatling_tpu_torch.ops.bounce_ref import P_TMIN, cutout_key, resident_work

    o, d = state[0:3].T.contiguous(), state[3:6].T.contiguous()
    key = cutout_key(state) if fs.cutout else None
    *_hit, boxes, tests = resident_work(fs.bvh, o, d, state[13] > 0.5, float(p[P_TMIN]), key)
    shadow = shadow_walk_work(fs, nee_shadow_rays(p, fs, state, nee))
    return int(boxes.sum()) + shadow[0], int(tests.sum()) + shadow[1]


def k1_walk_bound_ms(p, fs, state, nee: bool):
    """The least time of one K1 launch on `state` for the work its BVH
    walks make (resident_walk_work): the state rows and every table (the
    tree's included) read once, against 24 operations a slab test and 30
    a triangle test at the f32 rate. Returns (ms, what bounds it), work."""
    work = resident_walk_work(p, fs, state, nee)
    nbytes = 2 * state.numel() * 4 + 4 * (fs.tris.numel() + fs.mats.numel() + fs.lights.numel()
                                          + sum(t.numel() for t in fs.bvh))
    return _bound(nbytes, work[0] * SLAB_FLOPS + work[1] * TRI_TEST_FLOPS), work


def _bound(nbytes: int, ops: int, peak: float = F32_FLOPS):
    """(least ms, what bounds it) for moving nbytes and doing ops f32
    operations at `peak` a second."""
    tb_, to = nbytes / HBM_BPS, ops / peak
    return max(tb_, to) * 1e3, "bytes" if tb_ >= to else "operations"


def cluster_walk_work(p, fs, state, nee: bool) -> tuple[int, int, int, int]:
    """(TLAS and entry slab tests, cluster-box slab tests, cluster-tree slab
    tests, triangle tests) of the two-level walks of one K2 (K3: NEE off)
    launch on `state`, from bounce_ref.cluster_work: every alive ray's
    closest-hit walk (its cutout words as the kernel's) and, with NEE,
    the any-hit walk of each shadow ray the twin traces."""
    from gatling_tpu_torch.ops.bounce_ref import P_TMIN, cluster_work, cutout_key

    o, d = state[0:3].T.contiguous(), state[3:6].T.contiguous()
    key = cutout_key(state) if fs.cutout else None
    work = [int(c.sum()) for c in cluster_work(fs.walk, o, d, state[13] > 0.5,
                                               float(p[P_TMIN]), key)[2:]]
    shadow = shadow_walk_work(fs, nee_shadow_rays(p, fs, state, nee))
    return tuple(w + c for w, c in zip(work, shadow))


def walk_ops(work) -> int:
    """f32 operations of the two-level walk's counted work
    (cluster_walk_work): 24 a slab test, 30 a triangle test."""
    tlas, boxes, tree, tests = work
    return (tlas + boxes + tree) * SLAB_FLOPS + tests * TRI_TEST_FLOPS


def floor_ops(floor) -> int:
    """f32 operations of the cluster floor (bounce_ref.walk_work:
    the entry boxes and cluster boxes entered before the hit): the 16
    cluster-box slab tests of each entry box and the 128 triangle tests of
    each cluster box, whatever the order; no TLAS node and no transform."""
    n_entries, n_clusters = floor
    return n_entries * 16 * SLAB_FLOPS + n_clusters * 128 * TRI_TEST_FLOPS


def k2_bound_ms(state, fs, ops: int):
    """The least time of one K2 launch: the state rows read and written
    and every table read once (the cluster trees' included; HBM), against
    `ops` f32 operations at the f32 rate (walk_ops of the counted work, or
    floor_ops of the cluster floor)."""
    nbytes = 2 * state.numel() * 4 + 4 * (fs.tris.numel() + fs.mats.numel()
                                          + fs.lights.numel() + sum(t.numel() for t in fs.walk))
    return _bound(nbytes, ops)


def time_ms(fn, state, reps: int = 7) -> float:
    """Median of `reps` timed launches on fresh copies of `state` (CUDA
    events around the call alone)."""
    import torch

    times = []
    for _ in range(reps + 1):
        s = state.clone()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(s)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def phase_kernel(device):
    """Phase 3: the kernel, through bounce_step, against its twin on the
    main path's ray waves; then both timed on the Cornell waves."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import bounce_ref

    cases = [("cornell", CORNELL, (), False, FULL_RES, FULL_RES, 2),
             ("cornell_nee", CORNELL, (bench_rect_light(),), True, FULL_RES, FULL_RES, 2),
             ("analytic_nee", ANALYTIC, (), True, ANALYTIC_RES, ANALYTIC_RES, ANALYTIC_SPP)]
    max_err, times = 0.0, {}
    for label, path, extra, nee, w, h, samples in cases:
        fs, cam = scene_tables(path, extra, device)
        lt = tuple(fs.light_types.tolist())
        wave = state = wave_state(cam, w, h, samples, device)
        for b in range(5):
            params = params_row(b, device)
            twin = state.clone()
            bounce_ref(params, fs.tris, fs.mats, fs.lights, lt, twin, nee)
            if b in (0, 4):
                got = state.clone()
                tb.bounce_step(params, fs, got, nee)
                torch.cuda.synchronize()
                bad_bits, outside, n, err = compare(got, twin)
                log(f"parity {label} bounce {b}: {bad_bits} rays with rows 12-15 not "
                    f"bit-equal, {outside} of {n} rays outside rtol {RTOL}/atol {ATOL} "
                    f"on rows 0-11, max abs err {err:.3g}")
                max_err = max(max_err, err)
                assert bad_bits <= n * (1 - MIN_AGREE), (label, b, bad_bits)
                assert outside <= n * (1 - MIN_AGREE), (label, b, outside)
            state = twin
        if path == CORNELL:
            p0 = params_row(0, device)
            bound, work = k1_walk_bound_ms(p0, fs, wave, nee)
            times[nee] = (time_ms(lambda s: tb.bounce_step(p0, fs, s, nee), wave),
                          time_ms(lambda s: bounce_ref(p0, fs.tris, fs.mats, fs.lights, lt, s, nee),
                                  wave, reps=3), bound, k1_bound_ms(wave, fs), work)
            log(f"timing {label} bounce 0 at {wave.shape[1]} rays: kernel "
                f"{times[nee][0]:.3f} ms, plain twin {times[nee][1]:.3f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]}; walk work {work} slab and triangle tests), "
                f"brute-force bound {times[nee][3][0]:.4f} ms ({times[nee][3][1]})")
    return max_err, times


def sphere_field_setup(device):
    """sphere_field's scene description, material index and table, and its
    instanced (gi's route) and flattened kernel tables, the key light in
    both."""
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.geometry import build_geometry
    from gatling_tpu_torch.render.lights import build_light_arrays
    from gatling_tpu_torch.render.material import build_material_table, lower_material
    from gatling_tpu_torch.scene.examples import sphere_field

    t0 = time.perf_counter()
    desc = sphere_field()
    mat_paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(mat_paths)}
    midx[None] = len(mat_paths)
    table = build_material_table([lower_material(desc.materials.get(p) if p else None)
                                  for p in midx])
    lights = build_light_arrays(desc.lights)
    inst, istatic = tb.build_fused_scene_instanced(desc.meshes, midx, table, lights, device)
    t1 = time.perf_counter()
    flat, fstatic = tb.build_fused_scene(build_geometry(desc.meshes, midx), table, lights, device)
    t2 = time.perf_counter()
    assert istatic.instanced and fstatic.clustered and not fstatic.instanced
    log(f"sphere_field: {fstatic.n_tris} triangles; instanced tables {istatic.n_l1} entries "
        f"over {istatic.n_clusters} unique clusters ({inst.tris.numel() * 4 / 1e6:.2f} MB, "
        f"built in {t1 - t0:.2f} s); flattened {fstatic.n_clusters} clusters in "
        f"{fstatic.n_l1} entries ({flat.tris.numel() * 4 / 1e6:.1f} MB, built in {t2 - t1:.2f} s)")
    return desc, midx, table, inst, flat


def phase_walk(device, sf):
    """Phase 3b: K2 against its twin on sphere_field's first wave and on the
    Cornell box's clustered tables against K1; then K2 and the twin timed,
    and K2 timed at bounces 1-5 with and without the coherence sort."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import (P_TMIN, bounce_ref, walk_closest,
                                                  walk_hit_attrs, walk_work)
    from gatling_tpu_torch.render.fused import coherence_keys

    desc, _midx, _table, inst, flat = sf
    cam = desc.first_camera()
    wave = wave_state(cam, SF_RES, SF_RES, SF_SPP, device, tiled=True)
    max_err = 0.0
    for label, fs in (("instanced", inst), ("flattened", flat)):
        lt = tuple(fs.light_types.tolist())
        for nee in (False, True):
            state = wave
            for b in range(5):
                params = params_row(b, device)
                twin = state.clone()
                bounce_ref(params, fs.tris, fs.mats, fs.lights, lt, twin, nee, fs.walk)
                if b in (0, 4):
                    got = state.clone()
                    tb.bounce_step(params, fs, got, nee)
                    torch.cuda.synchronize()
                    bad_bits, outside, n, err = compare(got, twin)
                    log(f"parity sphere_field {label} nee={nee} bounce {b}: {bad_bits} rays "
                        f"with rows 12-15 not bit-equal, {outside} of {n} rays outside rtol "
                        f"{RTOL}/atol {ATOL} on rows 0-11, max abs err {err:.3g}")
                    max_err = max(max_err, err)
                    assert bad_bits <= n * (1 - MIN_AGREE), (label, nee, b, bad_bits)
                    assert outside <= n * (1 - MIN_AGREE), (label, nee, b, outside)
                state = twin

    # Cornell in clustered tables (one cluster) against K1's resident step;
    # not folded into max_err, which is the kernel against its twin: the two
    # branches compute t differently, so a ray on a triangle edge can flip
    for nee, extra in ((False, ()), (True, (bench_rect_light(),))):
        res, cam_c = scene_tables(CORNELL, extra, device)
        clu, _ = scene_tables(CORNELL, extra, device, resident_max=0)
        assert clu.walk is not None and res.walk is None
        state = wave_state(cam_c, FULL_RES, FULL_RES, 2, device)
        for b in range(5):
            params = params_row(b, device)
            ref = state.clone()
            tb.bounce_step(params, res, ref, nee)
            if b in (0, 4):
                got = state.clone()
                tb.bounce_step(params, clu, got, nee)
                torch.cuda.synchronize()
                bad_bits, outside, n, err = compare(got, ref)
                log(f"parity cornell clustered (K2) vs resident (K1) nee={nee} bounce {b}: "
                    f"{bad_bits} rays with rows 12-15 not bit-equal, {outside} of {n} outside "
                    f"tolerance, max abs err {err:.3g}")
                assert bad_bits <= n * (1 - MIN_AGREE) and outside <= n * (1 - MIN_AGREE)
            state = ref

    # timing at bounce 0: the wave as generated (tiled pixels) and sorted
    # by the coherence key as render_pixels_fused sorts after a bounce
    box = inst.walk.l1
    lo = box[:, 0:3].min(dim=0).values
    inv = 1.0 / torch.clamp(box[:, 3:6].max(dim=0).values - lo, min=1e-12)

    def sort(s):  # one bounce's sort in render_pixels_fused
        order = torch.argsort(coherence_keys(s, lo, inv), stable=True)
        return s[:, order], order

    waves = {"generated": wave, "sorted": sort(wave)[0]}
    p0 = params_row(0, device)
    times = {}
    for label, fs in (("instanced", inst), ("flattened", flat)):
        lt = tuple(fs.light_types.tolist())
        o, d, alive = wave[0:3].T.contiguous(), wave[3:6].T.contiguous(), wave[13] > 0.5
        tmin = float(p0[P_TMIN])
        win = walk_closest(fs.walk, fs.tris, o, d, alive, tmin)
        floor = walk_work(fs.walk, o, d, alive, tmin,
                          walk_hit_attrs(fs.walk, fs.tris, o, d, win)[0])
        hits = int((win >= 0).sum())
        for nee in (False, True):
            t_work = time.perf_counter()
            work = cluster_walk_work(p0, fs, wave, nee)
            bound, floor_bound = k2_bound_ms(wave, fs, walk_ops(work)), k2_bound_ms(
                wave, fs, floor_ops(floor))
            log(f"K2 sphere_field {label} nee={nee} bounce 0: walk work {work} (TLAS, cluster "
                f"box, tree slab tests; triangle tests), counted in "
                f"{time.perf_counter() - t_work:.1f} s; cluster floor {floor} (entry and "
                f"cluster boxes entered before the hit)")
            for order, wv in waves.items():
                k = time_ms(lambda s: tb.bounce_step(p0, fs, s, nee), wv)
                twin = time_ms(lambda s: bounce_ref(p0, fs.tris, fs.mats, fs.lights, lt, s, nee,
                                                    fs.walk), wv, reps=2)
                times[(label, order, nee)] = (k, twin, bound, floor_bound, work)
                log(f"timing K2 sphere_field {label} wave {order} nee={nee} bounce 0 at "
                    f"{wv.shape[1]} rays ({hits} hit): kernel {k:.3f} ms, plain twin "
                    f"{twin:.1f} ms, bound {bound[0]:.4f} ms ({bound[1]}), cluster floor "
                    f"{floor_bound[0]:.4f} ms ({floor_bound[1]})")

    # bounces 1-5 of a frame: K2 on the state as the last bounce left it
    # (the ray order of a frame without the sort) and sorted by the
    # coherence key (the order render_pixels_fused gives it), and the sort
    sorted_ms = {}
    for label, fs in (("instanced", inst), ("flattened", flat)):
        for nee in (False, True):
            state = wave.clone()
            tb.bounce_step(p0, fs, state, nee)
            sums = [0.0, 0.0, 0.0]
            for b in range(1, SF_BOUNCES):
                params = params_row(b, device)
                alive = int((state[13] > 0.5).sum())
                k_as_is = time_ms(lambda s: tb.bounce_step(params, fs, s, nee), state)
                k_sorted = time_ms(lambda s: tb.bounce_step(params, fs, s, nee), sort(state)[0])
                t_sort = time_ms(sort, state)
                for i, v in enumerate((k_as_is, k_sorted, t_sort)):
                    sums[i] += v
                bound = k2_bound_ms(state, fs, walk_ops(cluster_walk_work(params, fs, state, nee)))
                log(f"timing K2 sphere_field {label} nee={nee} bounce {b} ({alive} rays alive): "
                    f"unsorted {k_as_is:.3f} ms, sorted {k_sorted:.3f} ms, the sort {t_sort:.3f} "
                    f"ms; bound {bound[0]:.4f} ms ({bound[1]})")
                tb.bounce_step(params, fs, state, nee)
            sorted_ms[(label, nee)] = sums
            log(f"timing K2 sphere_field {label} nee={nee} bounces 1-5: unsorted {sums[0]:.3f} ms, "
                f"sorted {sums[1]:.3f} ms + the sorts {sums[2]:.3f} ms")
    return max_err, times, sorted_ms


def image_checks(img, label):
    """The Cornell image checks of tests/test_render_cornell.py."""
    import numpy as np

    h, w = img.shape[:2]
    assert np.isfinite(img).all(), label
    assert (img >= 0).all(), label
    lum = img[..., :3].mean(-1)
    iy, _ix = np.unravel_index(lum.argmax(), lum.shape)
    assert iy > h * 0.6 and lum.max() > 5.0, (label, iy, lum.max())
    mid = img[int(h * 0.4):int(h * 0.6)]
    left = mid[:, int(w * 0.07):int(w * 0.15), :3].mean(axis=(0, 1))
    right = mid[:, int(w * 0.85):int(w * 0.93), :3].mean(axis=(0, 1))
    assert left[0] > 2.0 * left[1] and left[0] > 2.0 * left[2], (label, left)
    assert right[1] > 2.0 * right[0] and right[1] > 2.0 * right[2], (label, right)


def counted_render(params, label):
    """One gi.render, timed to the end of the host copies, all eight
    kernels' launch counts and the texture stage's call count
    (ops/split_ref.py stage_calls, read by the caller) set to 0 just before
    it and read just after; returns (COLOR buffer, seconds, Mray/s or
    None, launches)."""
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.ops import trace as tt

    for counts in (tb.launches, tt.launches):
        for k in counts:
            counts[k] = 0
    split_ref.stage_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gi.render(params)
    dt = time.perf_counter() - t0
    launches = {**tb.launches, **tt.launches}
    segs = params.scene.last_segments
    mrays = segs / dt / 1e6 if segs else None
    log(f"render {label}: {dt:.4f} s wall, {segs:.0f} traced segments, "
        f"{'-' if mrays is None else f'{mrays:.1f}'} Mray/s, kernel launches {launches}, "
        f"texture stage calls {split_ref.stage_calls}")
    return params.aov_bindings[0].render_buffer.data.copy(), dt, mrays, launches


def warm_render(params, label):
    """A first frame (scene build included), then the timed warm frame
    on the same scene and samples (counted_render's return)."""
    from gatling_tpu_torch import gi

    counted_render(params, label + " (first frame)")
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    return counted_render(params, label + " (warm)")


def cornell_params(device, settings, lights=()):
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AovId

    scene, desc, merged = load_gi_scene(CORNELL, device, settings)
    for light in lights:
        scene.add_light(light)
    buf = gi.GiRenderBuffer(FULL_RES, FULL_RES, 4)
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                             aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf)],
                             render_settings=merged)


def sphere_field_params(device, sf, nee: bool):
    """gi render parameters of sphere_field at the bench's settings."""
    return desc_params(device, sf[0], SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                   nextEventEstimation=nee))


def sphere_field_classes(device, sf):
    """Per pixel of a 512x512 frame, from the ray through its centre: whether
    it first hits the ground or a sphere, and whether that point sees the
    key light's centre (a twin walk toward it) with its normal facing it."""
    import torch

    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops.bounce_ref import walk_closest, walk_hit_attrs, walk_occluded
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays

    desc, _midx, _table, inst, _flat = sf
    n = SF_RES * SF_RES
    pix = torch.arange(n, device=device)
    o, d, _ = generate_primary_rays(camera_uniforms(desc.first_camera(), False, device), SF_RES,
                                    SF_RES, pix % SF_RES, pix // SF_RES, smp.rng_init(pix, 0),
                                    False, False, False)
    win = walk_closest(inst.walk, inst.tris, o, d, torch.ones(n, dtype=torch.bool, device=device),
                       0.0)
    t, _u, _v, gn, *_rest = walk_hit_attrs(inst.walk, inst.tris, o, d, win)
    obj = torch.where(win >= 0, inst.walk.inst[(win // 2048).clamp(min=0), 13], -1.0)
    hit = win >= 0
    pos = o + torch.where(hit, t, 0.0)[:, None] * d
    gnv = torch.stack(gn, 1)
    gnv = torch.where(((gnv * d).sum(1) > 0)[:, None], -gnv, gnv)  # facing the camera
    to_l = torch.as_tensor(desc.lights[0].transform[3, :3], dtype=torch.float32,
                           device=device) - pos
    dist = to_l.norm(dim=1)
    ldir = to_l / dist[:, None]
    cosl = (gnv * ldir).sum(1)
    faces = hit & (cosl > 0.2)
    origin = pos + gnv * 1e-3
    occ = torch.zeros(n, dtype=torch.bool, device=device)
    idx = faces.nonzero()[:, 0]
    occ[idx] = walk_occluded(inst.walk, inst.tris, origin[idx], ldir[idx], dist[idx] - 1.0)
    ground = obj == 8.0
    spheres = hit & (obj < 8.0)
    lit = faces & ~occ
    return {k: v.cpu().numpy().reshape(SF_RES, SF_RES) for k, v in dict(
        lit_ground=ground & lit, shadowed_ground=ground & ~lit,
        lit_spheres=spheres & lit, dark_spheres=spheres & (cosl < -0.2)).items()}


def phase_sphere_field(device, sf):
    """Phases 4b and 4c: sphere_field through gi.render, NEE off and on, the
    same frame through the flattened tables, and a transform edit."""
    import numpy as np
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.geometry import build_geometry
    from gatling_tpu_torch.render.camera import camera_uniforms
    from gatling_tpu_torch.render.fused import render_pixels_fused
    from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms

    out, imgs = {}, {}
    for nee in (False, True):
        params = sphere_field_params(device, sf, nee)
        label = f"sphere_field {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee={nee}"
        img, _dt, out[f"sphere_field{'_nee' if nee else ''}"], launches = counted_render(
            params, label)
        assert params.scene._fused_static.instanced
        assert launches["K1"] == 0 and launches["K2"] > 0, launches
        if not nee:
            k2_launches = launches["K2"]  # the main path's sphere_field frame
        assert np.isfinite(img).all() and (img >= 0).all(), label
        imgs[nee] = img[..., :3]
        if nee:
            _, _dt, warm, _ = counted_render(params, label + " (second frame, warm)")
    assert imgs[True].mean() > imgs[False].mean() * 1.02, "NEE must add light"

    # NEE's direct light lands where the key light is seen: the lit ground
    # and the spheres' lit sides gain more than the ground in the spheres'
    # shadows and the sides turned away from the light, which gain only
    # through later bounces (at 64x64 x 2 spp on the CPU twin: 2.8 and 2.7
    # times as much)
    cls = sphere_field_classes(device, sf)
    gain = (imgs[True] - imgs[False]).mean(-1)
    means = {k: float(gain[m].mean()) for k, m in cls.items()}
    log(f"NEE gain by first-hit class {means}, pixels "
        f"{ {k: int(m.sum()) for k, m in cls.items()} }")
    assert means["lit_ground"] > 1.5 * max(means["shadowed_ground"], 1e-3)
    assert means["lit_spheres"] > 1.5 * max(means["dark_spheres"], 1e-3)
    lum = imgs[True].mean(-1)
    assert lum[cls["lit_ground"]].mean() > lum[cls["shadowed_ground"]].mean()

    # the same frame through the flattened tables, render_pixels_fused direct
    desc, _midx, _table, inst, flat = sf
    params = sphere_field_params(device, sf, True)
    gi.render(params)
    inst_img = params.aov_bindings[0].render_buffer.data[..., :3].copy()
    s = params.render_settings
    cfg = RenderConfig(width=SF_RES, height=SF_RES, spp=SF_SPP, max_bounces=SF_BOUNCES,
                       nee=True)
    uni = Uniforms(camera=camera_uniforms(desc.first_camera(), False, device), sample_offset=0,
                   inv_total_sample_count=1.0 / SF_SPP, max_sample_value=10.0,
                   rr_inv_min_term_prob=0.95, light_intensity_multiplier=1.0,
                   meters_per_scene_unit=1.0, max_volume_walk_length=7)
    assert s["spp"] == SF_SPP
    t0 = time.perf_counter()
    flat_img = render_pixels_fused(cfg, uni, flat, torch.arange(SF_RES * SF_RES, device=device),
                                   SF_SPP, 0).cpu().numpy().reshape(SF_RES, SF_RES, 3)
    log(f"render sphere_field through the flattened tables (render_pixels_fused, nee): "
        f"{time.perf_counter() - t0:.3f} s")
    rel = abs(flat_img.mean() - inst_img.mean()) / inst_img.mean()
    close = (np.abs(flat_img - inst_img) <= 1e-3 * np.maximum(1.0, np.abs(inst_img))).all(-1).mean()
    log(f"sphere_field instanced vs flattened: mean rel diff {rel:.2e}, {close:.5f} of pixels "
        "within 1e-3")
    assert rel < 5e-3 and close >= 0.99

    # 4c: move one sphere group as its PointInstancer's next time sample
    # would, tell the scene, render; the refit rebuilds the instance tables
    # over the cached unique clusters and must equal a build from scratch
    scene = params.scene
    tris0 = scene._fused.tris
    group = scene.meshes[3]
    shift = np.eye(4)
    shift[3, :3] = [0.3, -0.2, 0.1]
    group.instance_transforms = group.instance_transforms @ shift
    t0 = time.perf_counter()
    scene.set_mesh_transform(group, group.transform)
    gi.render(params)
    log(f"transform edit + frame: {time.perf_counter() - t0:.3f} s")
    assert scene._fused.tris is tris0  # the unique cluster table stayed on the card
    fresh, _ = tb.build_fused_scene_instanced(scene.meshes, scene._material_index,
                                              scene._material_table, scene._light_arrays, device)
    refit = [scene._fused.tris, *scene._fused.walk]
    assert all(torch.equal(a, b) for a, b in zip(refit, [fresh.tris, *fresh.walk]))
    assert not torch.equal(scene._fused.walk.l1, inst.walk.l1)
    fresh_geom = build_geometry(scene.meshes, scene._material_index)
    assert all(np.array_equal(a, b) for a, b in zip(scene._geom, fresh_geom))
    edited = params.aov_bindings[0].render_buffer.data[..., :3]
    assert np.isfinite(edited).all() and abs(edited.mean() - inst_img.mean()) / inst_img.mean() < 0.05
    log("transform refit: instance tables equal a build from scratch and geometry a fresh "
        "geometry build, bit for bit")
    out["sphere_field_nee_warm"] = warm
    return out, k2_launches


def phase_renders(device):
    """Phases 4 and 5: the main path at full size, and progressive frames."""
    import numpy as np

    from gatling_tpu_torch.cli import render_scene_file

    settings = dict(spp=16, maxBounces=8)
    out = {}
    img, _dt, mr, launches = counted_render(cornell_params(device, settings),
                                     f"cornell {FULL_RES}^2 16spp 8 bounces")
    image_checks(img, "cornell")
    assert launches["K1"] > 0 and launches["K2"] == 0, launches
    k1_launches = launches["K1"]  # the main path's Cornell frame
    out["cornell"] = mr
    img_nee, _dt, mr, _ = counted_render(
        cornell_params(device, dict(settings, nextEventEstimation=True), [bench_rect_light()]),
        f"cornell + NEE rect light {FULL_RES}^2 16spp 8 bounces")
    image_checks(img_nee, "cornell_nee")
    assert img_nee[..., :3].mean() > img[..., :3].mean(), "NEE must add light"
    out["cornell_nee"] = mr

    # Lights.Analytic at its authored resolution and render settings; the
    # plain twin on the CPU renders the same samples as the reference
    t0 = time.perf_counter()
    gpu, scene = render_scene_file(ANALYTIC, 96, 96, {}, device=device)
    dt = time.perf_counter() - t0
    out["analytic"] = scene.last_segments / dt / 1e6
    log(f"render Lights.Analytic 96x96 24spp 2 bounces NEE: {dt:.3f} s wall "
        f"(scene build included), {out['analytic']:.1f} Mray/s")
    cpu, _ = render_scene_file(ANALYTIC, 96, 96, {}, device="cpu")
    assert np.isfinite(gpu).all() and (gpu >= 0).all() and gpu[..., :3].mean() > 0.01
    rel = abs(gpu[..., :3].mean() - cpu[..., :3].mean()) / cpu[..., :3].mean()
    close = np.isclose(gpu[..., :3], cpu[..., :3], rtol=1e-3, atol=1e-3).all(-1).mean()
    log(f"Lights.Analytic card vs CPU twin: mean rel diff {rel:.2e}, {close:.4f} of pixels "
        "within 1e-3")
    assert rel < 1e-2 and close >= 0.99

    # progressive accumulation: three requests on one scene
    params = cornell_params(device, dict(spp=16, maxBounces=8))
    imgs = []
    for expect in (16, 32, 48):
        img, _dt, mr, _ = counted_render(params, f"progressive frame -> sampleOffset {expect}")
        assert params.scene.sample_offset == expect, params.scene.sample_offset
        imgs.append(img[..., :3])
    means = [float(i.mean()) for i in imgs]
    grads = [float(np.abs(np.diff(i, axis=1)).mean()) for i in imgs]
    log(f"progressive means {means}, gradient noise {grads}")
    assert abs(means[2] - means[0]) / means[0] < 0.02
    assert grads[2] < grads[1] < grads[0]
    return out, k1_launches


def write_textures(tex_dir: str) -> dict[str, str]:
    """The bench's extra textures (bench.py:81-122): a leaning tangent-space
    normal map (2x2) and the 64x64 checker of cornell_textured."""
    import numpy as np

    from gatling_tpu_torch import imgio

    lean = np.zeros((2, 2, 4), np.uint8)
    lean[...] = (200, 128, 230, 255)
    c = (np.arange(64)[:, None] // 8 + np.arange(64)[None, :] // 8) % 2
    checker = np.stack([np.where(c, 230, 90), np.where(c, 200, 120), np.where(c, 90, 220),
                        np.full_like(c, 255)], -1).astype(np.uint8)
    out = {"lean": os.path.join(tex_dir, "lean.png"),
           "checker": os.path.join(tex_dir, "checker.png")}
    imgio.write_image_file(out["lean"], lean)
    imgio.write_image_file(out["checker"], checker)
    return out


def texture_every_material(materials: dict, surface_input: str, file: str) -> None:
    """Connect a raw UsdUVTexture of `file` to `surface_input` of every
    material (a normal input takes lower_material's default scale 2, bias
    -1, as the bench's normal map does)."""
    from gatling_tpu_torch.scene.stage import ShaderNode

    for m in materials.values():
        node = ShaderNode(path=f"{m.path}/{surface_input}_tex", shader_id="UsdUVTexture",
                          inputs={"file": file, "sourceColorSpace": "raw"},
                          input_connections={})
        m.nodes[node.path] = node
        m.nodes[m.surface_node].input_connections[surface_input] = (node.path, "rgb")


def split_tables(params, flattened: bool = False):
    """The split kernels' tables of a scene that gi.render rendered, as the
    frame used them: (fused scene, static, device material table, texture
    pool, textured parameters). With `flattened`, gi's flattened build of
    the same geometry and kernel material table replaces its own route."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb

    scene = params.scene
    fs, static = scene._fused, scene._fused_static
    if flattened:
        fs, static, _order = tb.build_fused_scene_with_order(
            scene._geom, gi._fused_mat_table(scene), scene._light_arrays, scene.device)
        static = gi._with_split(scene, static)
    return fs, static, scene._material_dev, scene._texture_pool, static.textured_params


def compare_hits(kernel_hit, twin_hit):
    """The kernel's hit buffer against the twin's: (rays whose H_HIT or H_MAT
    rows are not bit-equal, rays outside rtol/atol on any row, n, max abs
    err over the twin's hit rays)."""
    import torch

    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT

    k, t = kernel_hit, twin_hit
    rows = [H_HIT, H_MAT]
    bad_bits = int((k[rows].view(torch.int32) != t[rows].view(torch.int32)).any(dim=0).sum())
    outside = int((~torch.isclose(k, t, rtol=RTOL, atol=ATOL).all(dim=0)).sum())
    hit = t[H_HIT] > 0.5
    max_err = float((k[:, hit] - t[:, hit]).abs().max()) if bool(hit.any()) else 0.0
    return bad_bits, outside, k.shape[1], max_err


def k3_bound_ms(state, fs, hit_rows: int, work, brute: bool = False,
                floor: bool = False) -> tuple[float, str]:
    """The least time of one K3 launch: each ray's origin, direction and
    alive flag read and its hit rows written once, the tables read once
    (HBM), against the triangle and box tests the wave's closest hits need
    (resident: the BVH walk's `work`, its slab and triangle tests from
    resident_walk_work, or with `brute` every alive ray against every
    triangle; walk: the counted work of cluster_walk_work, or with `floor`
    the cluster floor of bounce_ref.walk_work)."""
    r = state.shape[1]
    nbytes = 4 * r * (7 + hit_rows) + 4 * (fs.tris.numel() + sum(
        t.numel() for t in (fs.walk or fs.bvh)))
    if fs.walk is None and brute:
        return _bound(nbytes, int((state[13] > 0.5).sum()) * fs.tris.shape[0] * TRI_TEST_FLOPS)
    if fs.walk is None:
        return _bound(nbytes, work[0] * SLAB_FLOPS + work[1] * TRI_TEST_FLOPS)
    return _bound(nbytes, floor_ops(work) if floor else walk_ops(work))


def k4_floor_ms(state, fs, par_rows: int) -> tuple[float, str]:
    """The floor PR 3-9 gave one K4 launch: the state read and written, 13
    hit rows and the texture stage's parameter rows read, the material and
    light tables read once (HBM); no texel, no operation."""
    r = state.shape[1]
    return _bound(4 * r * (2 * 16 + 13 + par_rows) + 4 * (fs.mats.numel() + fs.lights.numel()),
                  0)


def tap_texel_rows(mats, pool, hit, textured: int):
    """The distinct texel rows the taps of one K4 launch on hit buffer
    `hit` read: for each hit ray and each tapped parameter (render/fused.py
    textured bits, ops/bounce.py TAP_BITS) and the normal map whose
    material binds a slot (and tap_rows' opacity with TAP_OPACITY), the
    texels_q22 row of its bilinear tap, or the texels_u32 entries (a float
    pool's `texels` rows, 16 bytes each) of its four texels that the wrap
    keeps, indexed as render/texture.py sample_pool indexes them. Returns
    the unique indices (torch.unique) and the bytes of one row."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT, H_UVX, H_UVY
    from gatling_tpu_torch.render.material import (MI_BASE_TEX, MI_EMISSIVE_TEX, MI_METAL_TEX,
                                                   MI_NORMAL_TEX, MI_OPACITY_TEX, MI_ROUGH_TEX)
    from gatling_tpu_torch.render.texture import _wrap_coord

    mask = tb.tap_mask(textured, hit.shape[0], pool)
    row_bytes = 16 if pool.bilinear_packed or not pool.packed else 4
    on = hit[H_HIT] > 0.5
    mat = torch.clamp(torch.round(hit[H_MAT][on]).to(torch.int64), 0,
                      mats.packed_i.shape[0] - 1)
    u, v = hit[H_UVX][on], hit[H_UVY][on]
    rows = [torch.zeros(0, dtype=torch.int64, device=hit.device)]
    for bit, col in ((tb.TAP_BITS["base_color"], MI_BASE_TEX),
                     (tb.TAP_BITS["emissive"], MI_EMISSIVE_TEX),
                     (tb.TAP_BITS["metallic"], MI_METAL_TEX),
                     (tb.TAP_BITS["roughness"], MI_ROUGH_TEX), (tb.TAP_NORMAL, MI_NORMAL_TEX),
                     (tb.TAP_OPACITY, MI_OPACITY_TEX)):
        if not mask & bit:
            continue
        slot = mats.packed_i[mat, col]
        sel = slot >= 0
        t = slot[sel].long()
        w, h, off = pool.width[t], pool.height[t], pool.offset[t]
        x0 = torch.floor(u[sel] * w.to(torch.float32) - 0.5).to(torch.int32)
        y0 = torch.floor((1.0 - v[sel]) * h.to(torch.float32) - 0.5).to(torch.int32)
        if pool.bilinear_packed:
            rows.append((off + torch.remainder(y0, h) * w + torch.remainder(x0, w)).long())
            continue
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xi, vx = _wrap_coord(x0 + dx, w, pool.wrap_s[t])
            yi, vy = _wrap_coord(y0 + dy, h, pool.wrap_t[t])
            rows.append((off + yi * w + xi)[vx & vy].long())
    return torch.unique(torch.cat(rows)), row_bytes


def k4_shadow_rays(p, fs, state, hit, mats, pool, active, nee):
    """The NEE shadow rays of one K4 launch on `state` and hit buffer `hit`,
    as its twin (the texture stage, then split_ref.shade_ref) traces them
    (traced_shadow_rays)."""
    from gatling_tpu_torch.ops.split_ref import par_row_starts, shade_ref
    from gatling_tpu_torch.ops.split_ref import material_rows

    def run():
        parbuf, hit_n = material_rows(mats, pool, hit, active)
        shade_ref(p, fs.tris, fs.mats, fs.lights, tuple(fs.light_types.tolist()), state.clone(),
                  hit_n, parbuf, par_row_starts(active), nee, fs.walk, fs.advanced, fs.cutout,
                  fs.volumes)
    return traced_shadow_rays(run) if nee else []


def k4_bound_ms(p, fs, state, hit, mats, pool, active, nee):
    """The least time of one K4 launch on `state` and K3's hit buffer `hit`
    (HBM bytes against f32 operations): the state read and written, the
    hit rows K4 reads (13, the uv when it taps, the 4 tangent rows when it
    normal-maps or frames the advanced lobes), the distinct texel rows its
    taps touch (tap_texel_rows: the least texel traffic), the tables read
    once (materials, lights, the slot columns and records, the sRGB table;
    with NEE the triangle rows and walk tables), against the counted work
    of the NEE shadow walks the twin traces (shadow_walk_work: 24
    operations a slab test, 30 a triangle test). The shading arithmetic is
    left out. Returns ((ms, what bounds it), shadow work, distinct texel
    rows)."""
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.split_ref import HIT_ROWS_TAN

    textured = sum(bit for name, bit in tb.TAP_BITS.items() if name in active)
    mask = tb.tap_mask(textured, hit.shape[0], pool)
    texels, row_bytes = tap_texel_rows(mats, pool, hit, textured)
    tangents = hit.shape[0] == HIT_ROWS_TAN and (fs.advanced or mask & tb.TAP_NORMAL)
    hit_rows = 13 + (2 if mask else 0) + (4 if tangents else 0)
    tables = fs.mats.numel() + fs.lights.numel() + mats.packed_i.numel() + 14 * pool.count + 256
    if nee:
        tables += fs.tris.numel() + sum(t.numel() for t in (fs.walk or fs.bvh))
    nbytes = 4 * state.shape[1] * (2 * 16 + hit_rows) + texels.numel() * row_bytes + 4 * tables
    work = shadow_walk_work(fs, k4_shadow_rays(p, fs, state, hit, mats, pool, active, nee))
    ops = walk_ops(work) if fs.walk is not None else work[0] * SLAB_FLOPS + work[1] * TRI_TEST_FLOPS
    return _bound(nbytes, ops), work, texels.numel()


def split_twin(p, fs, state, hit, mats, pool, active, nee):
    """K4's twin in place: the texture stage (render/fused.py
    material_rows) on K3's hit buffer, then split_ref.shade_ref."""
    from gatling_tpu_torch.ops.split_ref import par_row_starts, shade_ref
    from gatling_tpu_torch.ops.split_ref import material_rows

    parbuf, hit_n = material_rows(mats, pool, hit, active)
    shade_ref(p, fs.tris, fs.mats, fs.lights, tuple(fs.light_types.tolist()), state, hit_n,
              parbuf, par_row_starts(active), nee, fs.walk, fs.advanced, fs.cutout, fs.volumes)


def phase_split(device, scenes: dict):
    """Phase 3c: K3 and K4 against their twins on the tables of the scenes
    that phase 4d rendered through gi: the interior's first wave (plain and
    normal-mapped, gi's instanced tables and the flattened ones, NEE off
    and on), interior_taps' (wrap modes clamp, mirror and black, sRGB
    slots, metallic and roughness from the b and g channels: the
    texels_u32 taps) and the textured Cornell box's (resident); then
    timed, with the texture stage K4's taps replace beside K4."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import P_TMIN, walk_work
    from gatling_tpu_torch.ops.split_ref import H_HIT, H_T, trace_ref
    from gatling_tpu_torch.ops.split_ref import material_rows
    from gatling_tpu_torch.render.fused import coherence_keys

    cases = []
    for label in ("interior", "interior_normalmapped", "interior_taps"):
        params = scenes[label]
        wave = wave_state(params.camera, SF_RES, SF_RES, SF_SPP, device, tiled=True)
        for flattened in ((False, True) if label != "interior_taps" else (False,)):
            t0 = time.perf_counter()
            tables = split_tables(params, flattened)
            st, pool = tables[1], tables[3]
            name = label + ("_flattened" if flattened else "")
            log(f"{name}: {st.n_tris} triangles, {'flattened' if flattened else 'gi'} tables "
                f"({st.n_instances} placements over {st.n_clusters} clusters, tangent rows "
                f"{st.tangents}), textured {tables[4]}, {pool.count} texture slots "
                f"(2x2 rows: {pool.bilinear_packed}); in {time.perf_counter() - t0:.2f} s")
            assert st.clustered and st.textured and st.instanced != flattened
            assert st.tangents == (label == "interior_normalmapped")
            assert pool.bilinear_packed == (label != "interior_taps")
            cases += [(name, tables, wave, nee) for nee in (False, True)]
    cparams = scenes["cornell_textured"]
    ctables = split_tables(cparams)
    assert not ctables[1].clustered and ctables[4] == ("base_color",)
    cwave = wave_state(cparams.camera, FULL_RES, FULL_RES, 2, device)
    cases.append(("cornell_textured", ctables, cwave, False))

    k3_err = k4_err = 0.0
    # the interior's state at bounce 2 (plain tables, NEE on) and K4's inputs there
    later = k4_later = None
    for label, (fs, static, mats, pool, active), wave, nee in cases:
        state = wave
        for b in range(5):
            params = params_row(b, device)
            hit = trace_ref(params, fs.tris, state, fs.walk)
            if b == 2 and label == "interior" and nee:
                later, k4_later = state, (hit, mats, pool, active, nee)
            twin = state.clone()
            split_twin(params, fs, twin, hit, mats, pool, active, nee)
            if b in (0, 4):
                got_hit = tb.trace_step(params, fs, state)
                got = state.clone()
                tb.shade_step(params, fs, got, hit, mats, pool, active, nee)
                # K4's taps alone against the texture stage, on the hit rays
                taps = tb.tap_rows(hit, mats, pool, active)
                taps_twin = tb.tap_rows_ref(hit, mats, pool, active)
                torch.cuda.synchronize()
                on = hit[H_HIT] > 0.5
                tb_bad = int((taps.view(torch.int32) != taps_twin.view(torch.int32))[:, on]
                             .any(dim=0).sum())
                hb, ho, n, herr = compare_hits(got_hit, hit)
                sb, so, _n, serr = compare(got, twin)
                log(f"parity {label} nee={nee} bounce {b}: K3 {hb} rays with H_HIT/H_MAT not "
                    f"bit-equal, {ho} of {n} outside rtol {RTOL}/atol {ATOL}, max abs err "
                    f"{herr:.3g} (hit rays); K4's taps {tb_bad} of {int(on.sum())} hit rays "
                    f"not bit-equal to the texture stage's; K4 {sb} rays with rows 12-15 not "
                    f"bit-equal, {so} outside on rows 0-11, max abs err {serr:.3g}")
                k3_err, k4_err = max(k3_err, herr), max(k4_err, serr)
                assert hb == 0 and sb == 0 and tb_bad == 0, (label, nee, b, hb, sb, tb_bad)
                for v in (ho, so):
                    assert v <= n * (1 - MIN_AGREE), (label, nee, b, ho, so)
            state = twin

    # timing at bounce 0 on the interior's wave (gi's tables, NEE on, the
    # main path's; K4 also NEE off) and the textured Cornell box's
    times = {}
    p0 = params_row(0, device)
    by_case = {(c[0], c[3]): c for c in cases}
    for label, (fs, static, mats, pool, active), wave, nee in (
            by_case[("interior", True)], by_case[("interior_taps", True)],
            by_case[("cornell_textured", False)]):
        hit = tb.trace_step(p0, fs, wave)
        alive = wave[13] > 0.5
        floor = None
        if fs.walk is not None:
            o, d = wave[0:3].T.contiguous(), wave[3:6].T.contiguous()
            floor = walk_work(fs.walk, o, d, alive, float(p0[P_TMIN]), hit[H_T])
            work = cluster_walk_work(p0, fs, wave, False)
        else:
            work = resident_walk_work(p0, fs, wave, False)
        k4_bound, k4_work, texels = k4_bound_ms(p0, fs, wave, hit, mats, pool, active, nee)
        t = dict(
            k3=time_ms(lambda s: tb.trace_step(p0, fs, s), wave),
            k3_twin=time_ms(lambda s: trace_ref(p0, fs.tris, s, fs.walk), wave, reps=2),
            stage=time_ms(lambda h: material_rows(mats, pool, h, active), hit),
            k4=time_ms(lambda s: tb.shade_step(p0, fs, s, hit, mats, pool, active, nee), wave),
            k4_nee_off=time_ms(lambda s: tb.shade_step(p0, fs, s, hit, mats, pool, active, False),
                               wave),
            k4_twin=time_ms(lambda s: split_twin(p0, fs, s, hit, mats, pool, active, nee), wave,
                            reps=2),
            k3_bound=k3_bound_ms(wave, fs, hit.shape[0], work),
            k3_bound_brute=(k3_bound_ms(wave, fs, hit.shape[0], floor, floor=True) if floor
                            else k3_bound_ms(wave, fs, hit.shape[0], work, brute=True)),
            k4_bound=k4_bound, k4_work=k4_work, k4_texels=texels,
            k4_floor=k4_floor_ms(wave, fs, 3 * len(active)),
            work=work, rays=wave.shape[1], hits=int((hit[0] > 0.5).sum()))
        times[label] = t
        log(f"timing {label} nee={nee} bounce 0 at {t['rays']} rays ({t['hits']} hit; walk work "
            f"{work}): K3 {t['k3']:.3f} ms (twin {t['k3_twin']:.1f} ms, bound "
            f"{t['k3_bound'][0]:.4f} ms {t['k3_bound'][1]}, "
            f"{'cluster floor' if floor else 'brute-force bound'} "
            f"{t['k3_bound_brute'][0]:.4f} ms); texture stage {t['stage']:.3f} ms (the stage "
            f"K4's taps replace), K4 {t['k4']:.3f} ms (NEE off {t['k4_nee_off']:.3f} ms; twin "
            f"{t['k4_twin']:.1f} ms; bound {t['k4_bound'][0]:.4f} ms {t['k4_bound'][1]}: shadow "
            f"walk work {k4_work}, {texels} distinct texel rows; PR 3-9 floor "
            f"{t['k4_floor'][0]:.4f} ms)")

    # K3 and K4 on a secondary wave: the interior at bounce 2 as the twin
    # left it and in the coherence order render_pixels_fused gives it,
    # against their bounds
    fs = by_case[("interior", True)][1][0]
    p2 = params_row(2, device)
    box = fs.walk.l1
    lo = box[:, 0:3].min(dim=0).values
    inv = 1.0 / torch.clamp(box[:, 3:6].max(dim=0).values - lo, min=1e-12)
    order = torch.argsort(coherence_keys(later, lo, inv), stable=True)
    ordered = later[:, order]
    hit = tb.trace_step(p2, fs, later)
    alive = later[13] > 0.5
    floor = walk_work(fs.walk, later[0:3].T.contiguous(), later[3:6].T.contiguous(), alive,
                      float(p2[P_TMIN]), hit[H_T])
    work = cluster_walk_work(p2, fs, later, False)
    k3_2 = [time_ms(lambda s: tb.trace_step(p2, fs, s), wv) for wv in (later, ordered)]
    bound = k3_bound_ms(later, fs, hit.shape[0], work)
    floor_bound = k3_bound_ms(later, fs, hit.shape[0], floor, floor=True)
    hit2, mats, pool, active, nee = k4_later
    hit2_ordered = hit2[:, order].contiguous()
    k4_2 = time_ms(lambda s: tb.shade_step(p2, fs, s, hit2_ordered, mats, pool, active, nee),
                   ordered)
    k4_2_bound, k4_2_work, texels_2 = k4_bound_ms(p2, fs, ordered, hit2_ordered, mats, pool,
                                                  active, nee)
    times["interior_bounce2"] = dict(k3_unsorted=k3_2[0], k3=k3_2[1], k3_bound=bound,
                                     k3_floor=floor_bound, work=work, k4=k4_2,
                                     k4_bound=k4_2_bound, k4_work=k4_2_work)
    log(f"timing interior K3 bounce 2 ({int(alive.sum())} rays alive; walk work {work}, "
        f"cluster floor {floor}): {k3_2[0]:.3f} ms as the twin left the wave, {k3_2[1]:.3f} ms "
        f"in the coherence order, bound {bound[0]:.4f} ms ({bound[1]}), cluster floor "
        f"{floor_bound[0]:.4f} ms ({floor_bound[1]}); K4 (NEE, coherence order) {k4_2:.3f} ms, "
        f"bound {k4_2_bound[0]:.4f} ms ({k4_2_bound[1]}; shadow walk work {k4_2_work}, "
        f"{texels_2} distinct texel rows)")
    return k3_err, k4_err, times


def interior_params(device, tex_dir: str, normal_map: str | None = None, means_of=None,
                    **settings):
    """gi render parameters of the textured interior at the bench's
    settings. With `normal_map`, the bench's normal map on every material;
    with `means_of` (a GiScene that rendered the interior), every base
    colour is a constant: its texture's mean in that scene."""
    from gatling_tpu_torch.render.material import substitute_texture_means
    from gatling_tpu_torch.scene.examples import _preview_material, interior

    desc = interior(tex_dir=tex_dir)
    if normal_map:
        texture_every_material(desc.materials, "normal", normal_map)
    if means_of is not None:
        pf = substitute_texture_means(means_of._material_table, means_of._texture_pool).packed_f
        for path, m in list(desc.materials.items()):
            inputs = dict(m.nodes[m.surface_node].inputs)
            inputs["diffuseColor"] = tuple(float(x) for x in pf[means_of._material_index[path], :3])
            desc.materials[path] = _preview_material(path, **inputs)
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True, **settings))


def tap_variants(desc) -> None:
    """K4's other taps, an edit in place of a textured scene: every texture
    decoded as sRGB and wrapping clamp, mirror or black (a material's
    wrapS and wrapT two of the three in turn: a pool that is not all
    `repeat`, tapped through texels_u32), and metallic and roughness read
    from the b and g channels of each material's texture."""
    from gatling_tpu_torch.scene.stage import ShaderNode

    modes = ("clamp", "mirror", "black")
    for k, m in enumerate(desc.materials.values()):
        wraps = dict(wrapS=modes[k % 3], wrapT=modes[(k + 1) % 3])
        files = []
        for node in m.nodes.values():
            if node.shader_id == "UsdUVTexture":
                node.inputs.update(sourceColorSpace="sRGB", **wraps)
                files.append(node.inputs["file"])
        surf = m.nodes[m.surface_node]
        for name, channel in (("metallic", "b"), ("roughness", "g")) if files else ():
            node = ShaderNode(path=f"{m.path}/{name}_tex", shader_id="UsdUVTexture",
                              inputs={"file": files[0], "sourceColorSpace": "raw", **wraps},
                              input_connections={})
            m.nodes[node.path] = node
            surf.input_connections[name] = (node.path, channel)


def interior_taps_params(device, tex_dir: str):
    """The textured interior at the bench's settings with tap_variants'
    textures."""
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(tex_dir=tex_dir)
    tap_variants(desc)
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True))


def phase_interior(device, tex_dir: str, extra: dict):
    """Phase 4d: the textured interior through gi.render (the main path's
    frame for K3 and K4), its checks and variants; the textured Cornell
    box at its bench settings."""
    import numpy as np
    import torch

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays

    out = {}
    params = interior_params(device, tex_dir)
    label = f"interior {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee"
    img, _dt, out["interior_first_frame"], launches = counted_render(params,
                                                                     label + " (first frame)")
    scene = params.scene
    st = scene._fused_static
    log(f"interior route: {'instanced' if st.instanced else 'flattened'} ({st.n_instances} "
        f"placements over {st.n_clusters} unique clusters, {st.n_tris} triangles flattened), "
        f"textured {st.textured_params}")
    assert st.instanced and st.textured and launches["K3"] > 0 and launches["K4"] > 0
    assert launches["K1"] == 0 and launches["K2"] == 0, launches
    split_launches = {k: launches[k] for k in ("K3", "K4")}
    scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, _dt, out["interior"], launches = counted_render(params, label + " (warm)")
    assert launches == dict(split_launches, K1=0, K2=0, K4t=0, K4f=0, K4tf=0, K5=0, K6=0, K7=0,
                            K8=0, B1=0, B2=0), launches
    # K4 taps the textures itself: no texture stage between K3 and K4
    assert split_ref.stage_calls == 0, split_ref.stage_calls
    out["interior_texture_stage_calls"] = split_ref.stage_calls
    img = img[..., :3]
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.01

    # per first-hit material (the centre ray of each pixel, K3), the frame's
    # mean against the mean of a frame whose base colours are the texture
    # means: diffuse and glossy responses are linear in the base colour
    n = SF_RES * SF_RES
    pix = torch.arange(n, device=device)
    o, d, _ = generate_primary_rays(camera_uniforms(params.camera, False, device), SF_RES,
                                    SF_RES, pix % SF_RES, pix // SF_RES, smp.rng_init(pix, 0),
                                    False, False, False)
    hit = tb.trace_step(params_row(0, device), scene._fused, tb.pack_state(o, d, pix, n))
    mat = torch.where(hit[H_HIT] > 0.5, hit[H_MAT], -1.0).cpu().numpy().reshape(SF_RES, SF_RES)
    mparams = interior_params(device, tex_dir, means_of=scene)
    mimg, _dt, _mr, _l = counted_render(mparams, label + " with the texture means as constants")
    assert not mparams.scene._fused_static.textured
    lum, mlum = img.mean(-1), mimg[..., :3].mean(-1)
    names = {i: p for p, i in scene._material_index.items()}
    ratios = {}
    for m in np.unique(mat[mat >= 0]).astype(int):
        sel = mat == m
        if sel.sum() >= 0.02 * n:
            ratios[names[m]] = float(lum[sel].mean() / max(mlum[sel].mean(), 1e-9))
    log(f"per-material mean over the means frame's {ratios}")
    # the two frames share their samples, so a ratio moves only with the
    # texture's variation about its mean: 1.0011-1.0057 on an H100 80GB
    # HBM3 (700 W); 0.02 is 3.5 times the largest deviation
    assert ratios and all(abs(r - 1.0) < 0.02 for r in ratios.values()), ratios

    # textureLodBounces=2: bounces 2-5 shade from the means (K1/K2 tables)
    lparams = interior_params(device, tex_dir, textureLodBounces=2)
    limg, _dt, out["interior_lod2"], llaunches = warm_render(lparams,
                                                             label + " textureLodBounces=2")
    limg = limg[..., :3]
    rel = abs(limg.mean() - img.mean()) / img.mean()
    log(f"interior lod2 vs all taps: mean rel diff {rel:.3e}; launches {llaunches}")
    assert llaunches["K2"] > 0 and llaunches["K3"] == llaunches["K4"] < split_launches["K3"]
    assert np.isfinite(limg).all() and rel < 0.05 and split_ref.stage_calls == 0

    nparams = interior_params(device, tex_dir, normal_map=extra["lean"])
    nimg, _dt, out["interior_normalmapped"], _ = warm_render(nparams, label + " normal-mapped")
    nimg = nimg[..., :3]
    assert nparams.scene._fused_static.tangents and np.isfinite(nimg).all() and (nimg >= 0).all()
    assert split_ref.stage_calls == 0, split_ref.stage_calls
    nrel = abs(nimg.mean() - img.mean()) / img.mean()
    log(f"interior normal-mapped vs plain: mean rel diff {nrel:.3e}")
    # the leaning normal moves the frame's mean by 6.261e-2 on an H100 80GB
    # HBM3 (700 W); the gate is half to twice that
    assert 0.03 < nrel < 0.12, nrel

    # the textured Cornell box (resident K3 and K4) at its bench settings
    cparams = cornell_params(device, dict(spp=16, maxBounces=8))
    texture_every_material(cparams.scene.materials, "diffuseColor", extra["checker"])
    cimg, _dt, out["cornell_textured"], claunches = warm_render(cparams, "cornell_textured "
                                                           f"{FULL_RES}^2 16spp 8 bounces")
    assert claunches["K3"] > 0 and claunches["K1"] == 0 and split_ref.stage_calls == 0
    assert np.isfinite(cimg).all() and (cimg >= 0).all() and cimg[..., :3].mean() > 0.01

    # interior_taps: wrap modes other than repeat, sRGB, channel picks
    tparams = interior_taps_params(device, tex_dir)
    timg, _dt, out["interior_taps"], tlaunches = warm_render(tparams, label + " interior_taps")
    tst = tparams.scene._fused_static
    log(f"interior_taps: textured {tst.textured_params}, pool of "
        f"{tparams.scene._texture_pool.count} slots, 2x2 rows "
        f"{tparams.scene._texture_pool.bilinear_packed}")
    assert tlaunches["K4"] == split_launches["K4"] and split_ref.stage_calls == 0
    assert {"metallic", "roughness"} <= set(tst.textured_params)
    assert np.isfinite(timg).all() and (timg >= 0).all() and timg[..., :3].mean() > 0.01
    scenes = {"interior": params, "interior_normalmapped": nparams, "cornell_textured": cparams,
              "interior_taps": tparams}
    return out, split_launches, scenes


AOVS_RES, AOVS_SPP, AOVS_BOUNCES = 1200, 16, 8  # cornell_aovs: the Cornell bench frame
INT_AOVS = ("OBJECT_ID", "FACE_ID", "INSTANCE_ID")
# operations a live ray spends on one triangle, counted from csrc/trace.cu
TRACE_OPS = {"K5": 58, "K6": 57, "K7": 54, "K8": 53}
# K7/K8, the least a pair needs: decided at det (d x e2 9, det 5, |det| 2)
# or at u (then the reciprocal 1, t - v0 3, u 6, one comparison); the
# rest TRACE_OPS (trace_ref.tiles_work sorts the pairs)
MT_DET_OPS, MT_U_OPS = 16, 27


def all_aov_bindings(w: int, h: int):
    """One binding of every AOV: the ids in int32 buffers cleared to -1,
    the others in float buffers of at least 3 channels."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId

    return [gi.GiAovBinding(a, gi.GiRenderBuffer(w, h, 1 if AOV_IS_INT[a] else
                                                 max(AOV_CHANNELS[a], 3), AOV_IS_INT[a]),
                            clear_value=-1 if AOV_IS_INT[a] else None) for a in AovId]


def cornell_aovs_params(device):
    """cornell_aovs: the Cornell box with the bench's rect light, every AOV
    bound, 1200x1200, 16 spp, 8 bounces, NEE."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene

    scene, desc, merged = load_gi_scene(CORNELL, device, dict(
        spp=AOVS_SPP, maxBounces=AOVS_BOUNCES, nextEventEstimation=True))
    scene.add_light(bench_rect_light())
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(),
                             aov_bindings=all_aov_bindings(AOVS_RES, AOVS_RES),
                             render_settings=merged)


def interior_aovs_params(device, tex_dir: str, detail: int = 1):
    """interior_aovs_small: interior(detail=1), 3,840 triangles (K5/K6's
    frame), or with detail=5 interior_aovs, the interior at full detail,
    92,492 triangles (B1/B2's); every AOV bound, 512x512, 4 spp, 6
    bounces, NEE."""
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(detail=detail, tex_dir=tex_dir)
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True), every_aov=True)


def timed_aov_render(params, label):
    """One more gi.render of every bound AOV (the framebuffer reset), as
    counted_render times and counts it; returns ({AovId: buffer}, seconds,
    launches)."""
    from gatling_tpu_torch import gi

    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    _img, dt, _mr, launches = counted_render(params, label)
    return {b.aov_id: b.render_buffer.data.copy() for b in params.aov_bindings}, dt, launches


def check_aovs(aovs, params, label):
    """Every AOV finite; ids within their ranges and present; the normals of
    hit pixels unit length."""
    import numpy as np

    from gatling_tpu_torch.interface import AovId

    scene = params.scene
    n_inst = sum(1 if m.instance_transforms is None else len(m.instance_transforms)
                 for m in scene.meshes)
    for aov, buf in aovs.items():
        assert np.isfinite(buf).all(), (label, aov)
    obj, face, inst = (aovs[AovId[k]][..., 0] for k in INT_AOVS)
    assert obj.min() >= -1 and obj.max() < len(scene.meshes) and (obj >= 0).mean() > 0.5, label
    assert inst.min() >= -1 and inst.max() < n_inst and face.min() >= -1, label
    assert ((obj >= 0) == (face >= 0)).all() and ((obj >= 0) == (inst >= 0)).all(), label
    nrm = aovs[AovId.NORMAL][..., :3][obj >= 0] * 2.0 - 1.0
    length = np.linalg.norm(nrm, axis=-1)
    log(f"{label}: {(obj >= 0).mean():.4f} of pixels hit, {len(np.unique(obj[obj >= 0]))} objects, "
        f"{len(np.unique(face[face >= 0]))} faces; normal lengths {length.min():.6f}-"
        f"{length.max():.6f}")
    assert np.abs(length - 1.0).max() < 1e-3, label


def record_hop_waves(params, bounces=(0, 2)):
    """One more frame of a wavefront frame with cutout, with the shadow
    hops of `bounces` of its first sample recorded: the rays each hop of
    render/integrator.py _trace_occluded_cutout hands K5 (origins,
    directions, tmin, tmax), as {"<bounce>/hop <k>": rays}."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.render import integrator

    calls, at = {}, {"bounce": -1, "hop": None}
    real_closest, real_cutout = integrator._trace_closest, integrator._trace_occluded_cutout

    def closest(config, accel, *rays):
        if at["hop"] is None:  # a path segment: the next bounce
            at["bounce"] += 1
        else:
            if at["bounce"] in bounces:
                calls[f"{at['bounce']}/hop {at['hop']}"] = tuple(r.clone() for r in rays)
            at["hop"] += 1
        return real_closest(config, accel, *rays)

    def cutout(*args, **kwargs):
        at["hop"] = 0
        try:
            return real_cutout(*args, **kwargs)
        finally:
            at["hop"] = None

    integrator._trace_closest, integrator._trace_occluded_cutout = closest, cutout
    try:
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        gi.render(params)
    finally:
        integrator._trace_closest, integrator._trace_occluded_cutout = real_closest, real_cutout
    return calls


def record_waves(params, bounces=(0, 2)):
    """One more frame of `params` with the wavefront's trace calls
    recorded: for sample 0, the closest-hit waves and the NEE shadow
    waves of `bounces` (origins, directions, tmin, tmax), as gi.render
    hands them to K5 and K6."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.render import integrator

    calls = {"closest": [], "occluded": []}
    real = {"closest": integrator._trace_closest, "occluded": integrator._trace_occluded}

    def recorder(kind):
        def fn(config, accel, *rays):
            if len(calls[kind]) <= max(bounces):
                calls[kind].append(tuple(r.clone() for r in rays))
            return real[kind](config, accel, *rays)
        return fn

    integrator._trace_closest = recorder("closest")
    integrator._trace_occluded = recorder("occluded")
    try:
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        gi.render(params)
    finally:
        integrator._trace_closest = real["closest"]
        integrator._trace_occluded = real["occluded"]
    return {kind: {b: calls[kind][b] for b in bounces if b < len(calls[kind])}
            for kind in calls}


def graphical_card_vs_cpu(device, name):
    """A tests/graphical scene at its own settings (96x96) with COLOR,
    ALBEDO and the id AOVs, on the card and through the twins on the CPU,
    the same samples. (Mesh.PrimvarInterpolation's COLOR is black: its
    only light is a distant light and the scene renders without NEE; its
    vertex colours show in the albedo.)"""
    import numpy as np

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AovId

    path = os.path.join(HERE, "tests", "graphical", name, "scene.usda")
    out = {}
    for dev in (device, "cpu"):
        scene, desc, merged = load_gi_scene(path, dev)
        binds = [b for b in all_aov_bindings(96, 96)
                 if b.aov_id in (AovId.COLOR, AovId.ALBEDO, *(AovId[k] for k in INT_AOVS))]
        gi.render(gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                                    render_settings=merged))
        assert scene._accel is not None, name  # the wavefront route
        out[str(dev)] = {b.aov_id: b.render_buffer.data for b in binds}
    gpu, cpu = out[str(device)], out["cpu"]
    same = {k: float((gpu[AovId[k]] == cpu[AovId[k]]).mean()) for k in INT_AOVS}
    rel = {}
    for aov in (AovId.COLOR, AovId.ALBEDO):
        g, c = gpu[aov][..., :3], cpu[aov][..., :3]
        assert np.isfinite(g).all() and (g >= 0).all(), (name, aov)
        rel[aov.name] = float(abs(g.mean() - c.mean()) / max(float(c.mean()), 1e-12))
    log(f"{name} card vs CPU twins: ids equal on {same}; mean rel diff {rel}; COLOR means "
        f"{gpu[AovId.COLOR][..., :3].mean():.6f} / {cpu[AovId.COLOR][..., :3].mean():.6f}")
    assert all(v >= 0.999 for v in same.values()) and all(v < 0.01 for v in rel.values())
    return same, rel


def phase_wavefront(device, tex_dir: str):
    """Phase 4e: cornell_aovs and interior_aovs_small through gi.render's
    wavefront route (K5 closest hits, K6 shadow rays): a first and warm frames, the
    checks, the launch counts; the two graphical scenes on the card against
    the CPU twins. Returns (frame seconds, launches of the Cornell warm
    frame, recorded waves and tables per scene)."""
    import numpy as np

    from gatling_tpu_torch.interface import AovId

    out, waves = {}, {}
    for label, params, warm_frames in (
            ("cornell_aovs", cornell_aovs_params(device), 1),
            ("interior_aovs_small", interior_aovs_params(device, tex_dir), 1)):
        desc = (f"{label} {params.aov_bindings[0].render_buffer.width}^2 "
                f"{params.render_settings['spp']}spp {params.render_settings['maxBounces']} "
                "bounces nee, every AOV")
        _aovs, out[label + "_first_frame"], _ = timed_aov_render(params, desc + " (first frame)")
        warm = []
        for i in range(warm_frames):
            aovs, dt, launches = timed_aov_render(params, desc + f" (warm {i + 1})")
            warm.append(dt)
        out[label + "_warm"] = warm
        scene = params.scene
        assert scene._tracer == "matrix" and scene._fused is None
        assert launches["K5"] > 0 and launches["K6"] > 0, launches
        assert all(launches[k] == 0 for k in ("K1", "K2", "K3", "K4", "K7", "K8")), launches
        if label == "cornell_aovs":
            wavefront_launches = {k: launches[k] for k in ("K5", "K6", "K7", "K8")}
            image_checks(aovs[AovId.COLOR], label)
        color = aovs[AovId.COLOR][..., :3]
        assert (color >= 0).all() and color.mean() > 0.01, label
        check_aovs(aovs, params, label)
        log(f"{label}: warm frames {[round(t, 4) for t in warm]} s, median "
            f"{float(np.median(warm)):.4f} s")
        waves[label] = (record_waves(params), scene._accel.tables, scene._geom)
    for name in ("Mesh.PrimvarInterpolation", "Render.AOVs"):
        out[name] = graphical_card_vs_cpu(device, name)
    return out, wavefront_launches, waves


def event_ms(fn, reps: int = 7) -> float:
    """Median of `reps` CUDA-event-timed calls of fn() after one warm-up."""
    import torch

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times[1:])


def trace_bound_ms(kernel: str, rays, table, ops: int, peak: float = F32_FLOPS):
    """The least time of one launch: each ray's o, d, tmin, tmax read once,
    its result written once (t, tri, u, v: 16 B; a flag: 1 B), the table
    read once (HBM), against `ops` operations (f32, at `peak`)."""
    n = rays[0].shape[0]
    out_bytes = 16 if kernel in ("K5", "K7") else 1
    return _bound(n * (32 + out_bytes) + 4 * table.numel(), ops, peak)


def tiles_ops(kernel: str, case: str, rays, tiles, last) -> tuple[int, int]:
    """The operations K7 or K8 needs on a wave, and its pairs: per live ray
    over the triangles 0 .. last[ray] (trace_ref.tiles_work), MT_DET_OPS a
    pair decided at det, MT_U_OPS one decided at u, TRACE_OPS[kernel] the
    rest. Logs the split."""
    from gatling_tpu_torch.ops import trace_ref as trf

    at_det, at_u, pairs = (int(x.sum()) for x in trf.tiles_work(*rays, tiles.tris, last))
    ops = at_det * MT_DET_OPS + at_u * MT_U_OPS + (pairs - at_det - at_u) * TRACE_OPS[kernel]
    log(f"{kernel} {case}: {pairs} pairs, {at_det} decided at det and {at_u} at u, "
        f"{ops} operations ({ops / max(pairs, 1):.2f} a pair)")
    return ops, pairs


def trace_walk_bound_ms(kernel: str, rays, bvh, work, peak: float = F32_FLOPS):
    """The least time of one K5 or K6 launch for the work its BVH walk
    makes (trace_ref.matrix_work / occluded_work: slab tests, triangle
    tests): each ray's o, d, tmin, tmax read and its result (t, tri, u, v;
    a flag) written once, the tree read once (HBM), against 24 operations
    a slab test and TRACE_OPS[kernel] a triangle test (f32, at `peak`)."""
    n = rays[0].shape[0]
    out_bytes = 16 if kernel == "K5" else 1
    return _bound(n * (32 + out_bytes) + 4 * sum(t.numel() for t in bvh),
                  work[0] * SLAB_FLOPS + work[1] * TRACE_OPS[kernel], peak)


def log_k8_sweep(case: str, first, alive, n_real: int, layout: dict, tested: int) -> None:
    """Logs the tests K8's layout implies beside the `tested` pairs its
    bound counts: a model, not a count from the kernel. A ray's group tests
    whole steps of k8_group * k8_rows rows from each chunk's first (one
    chunk of every row when the table is resident), up to the step that
    holds its first occluder (`first`, trace_ref's index; -1: none, every
    row tested)."""
    import torch

    g = layout["k8_group"] * layout["k8_rows"]
    chunk = layout["chunk_rows"] if n_real > layout["resident_rows"] else max(n_real, 1)
    f = first[alive].long()
    lo = torch.div(f.clamp(min=0), chunk, rounding_mode="floor") * chunk
    steps = torch.div(f - lo + g, g, rounding_mode="floor")  # up to the occluder's step
    rows = (n_real - lo).clamp(max=chunk)  # the occluder's chunk's rows
    swept = int(torch.where(f >= 0, lo + (steps * g).minimum(rows), n_real).sum())
    log(f"K8 {case}: {tested} tests up to the first occluders; K8's layout implies {swept} "
        f"({swept - tested} past them)")


def phase_trace(device, waves: dict):
    """Phase 3d: K5-K8 against their twins on the waves 4e's frames handed
    the tracer (and 4f's cutout shadow hops), on the tables gi built: tri,
    t, u, v bit-equal on every ray, the occlusion flags equal on every ray;
    K7 against K5; each kernel and twin timed (trace_timing); K8's sweep
    as its layout implies it (log_k8_sweep)."""
    import torch

    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf

    layout = tt.kernel().layout()
    results = {}
    for label, (recorded, tables, geom) in waves.items():
        tiles = tt.build_tri_tiles(geom, device)
        n_real = tiles.n_real
        for bounce, rays in recorded["closest"].items():
            live = int((rays[3] > rays[2]).sum())
            got5, got7 = tt.intersect_matrix(*rays, tables), tt.intersect_tiles(*rays, tiles)
            ref5 = trf.intersect_matrix_ref(*rays, tables.coeffs)
            ref7 = trf.intersect_tiles_ref(*rays, tiles.tris)
            torch.cuda.synchronize()
            bad, err = {}, {}
            for k, got, ref in (("K5", got5, ref5), ("K7", got7, ref7)):
                bad[k] = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
                             for g, r in zip(got, ref))
                hit = ref[1] >= 0
                err[k] = max(float((g[hit] - r[hit]).abs().max()) if bool(hit.any()) else 0.0
                             for g, r in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])))
            agree = float((got5.tri == got7.tri).float().mean())
            log(f"parity {label} bounce {bounce} closest ({rays[0].shape[0]} rays, {live} live, "
                f"{int((ref5[1] >= 0).sum())} hits): K5 {bad['K5']} and K7 {bad['K7']} values "
                f"not bit-equal to their twins; K7 takes K5's triangle on {agree:.6f}")
            assert bad["K5"] == 0 and bad["K7"] == 0 and agree >= 0.99
            *walked, boxes, tests = trf.matrix_work(tables.bvh, *rays)
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(walked, ref5)), (label, bounce)  # the plain walk's hit
            work = (int(boxes.sum()), int(tests.sum()))
            ops7, _ = tiles_ops("K7", f"{label} bounce {bounce}", rays, tiles,
                                torch.full_like(ref7[1], n_real - 1))
            for k, fn, twin, table, ops, walk in (
                    ("K5", lambda r=rays: tt.intersect_matrix(*r, tables),
                     lambda r=rays: trf.intersect_matrix_ref(*r, tables.coeffs), tables.coeffs,
                     live * n_real * TRACE_OPS["K5"], (tables.bvh, work)),
                    ("K7", lambda r=rays: tt.intersect_tiles(*r, tiles),
                     lambda r=rays: trf.intersect_tiles_ref(*r, tiles.tris), tiles.rows, ops7,
                     None)):
                results[(k, label, bounce)] = trace_timing(k, fn, twin, rays, table, ops,
                                                           err[k], walk)
        for bounce, rays in recorded["occluded"].items():
            live = int((rays[3] > rays[2]).sum())
            got6, got8 = tt.occluded_matrix(*rays, tables), tt.occluded_tiles(*rays, tiles)
            first6 = trf.occluded_matrix_ref(*rays, tables.coeffs, first=True)
            first8 = trf.occluded_tiles_ref(*rays, tiles.tris, first=True)
            torch.cuda.synchronize()
            bad6, bad8 = int((got6 != (first6 >= 0)).sum()), int((got8 != (first8 >= 0)).sum())
            log(f"parity {label} bounce {bounce} shadow rays ({rays[0].shape[0]} rays, {live} "
                f"traced, {int(got6.sum())} occluded): K6 {bad6}, K8 {bad8} flags off their twins")
            assert bad6 == 0 and bad8 == 0
            err = {"K6": float((got6 != (first6 >= 0)).float().max()),
                   "K8": float((got8 != (first8 >= 0)).float().max())}
            walked, boxes, tests = trf.occluded_work(tables.bvh, *rays)
            assert torch.equal(walked, first6 >= 0), (label, bounce)  # the plain walk's flags
            work = (int(boxes.sum()), int(tests.sum()))
            case = f"{label} bounce {bounce}"
            alive = rays[3] > rays[2]
            tested6 = int(torch.where(first6 >= 0, first6 + 1, n_real)[alive].sum())
            ops8, tested8 = tiles_ops("K8", case, rays, tiles,
                                      torch.where(first8 >= 0, first8, n_real - 1))
            log_k8_sweep(case, first8, alive, n_real, layout, tested8)
            for k, fn, twin, table, ops, walk in (
                    ("K6", lambda r=rays: tt.occluded_matrix(*r, tables),
                     lambda r=rays: trf.occluded_matrix_ref(*r, tables.coeffs), tables.coeffs,
                     tested6 * TRACE_OPS["K6"], (tables.bvh, work)),
                    ("K8", lambda r=rays: tt.occluded_tiles(*r, tiles),
                     lambda r=rays: trf.occluded_tiles_ref(*r, tiles.tris), tiles.rows, ops8,
                     None)):
                results[(k, label, bounce)] = trace_timing(k, fn, twin, rays, table, ops,
                                                           err[k], walk)
    log_trace_times(results)
    return results


def trace_timing(k, fn, twin, rays, table, ops: int, err: float, walk=None) -> dict:
    """Phase 3d's record of one K5-K8 launch on one wave: the kernel and its
    twin timed with CUDA events, and its bound at the published f32 peak
    and at one FP32 instruction an operation (`bound_nc`): of `ops` (K7,
    K8: tiles_ops), or of K5's or K6's walk (`walk`: the tree and its
    work) with brute force's `ops` beside it (`bound_brute`)."""
    bounds = [trace_walk_bound_ms(k, rays, walk[0], walk[1], peak) if walk
              else trace_bound_ms(k, rays, table, ops, peak)
              for peak in (F32_FLOPS, FP32_INSTR_RATE)]
    out = dict(ms=event_ms(fn), plain_ms=event_ms(twin, reps=2), rays=rays[0].shape[0],
               live=int((rays[3] > rays[2]).sum()), err=err, bound=bounds[0], bound_nc=bounds[1])
    if walk:
        out.update(work=walk[1], bound_brute=trace_bound_ms(k, rays, table, ops))
    return out


def log_trace_times(results: dict) -> None:
    for (k, label, bounce), r in sorted(results.items()):
        walk = (f"; walk work {r['work']} slab and triangle tests, brute-force bound "
                f"{r['bound_brute'][0]:.4f} ms" if "work" in r else "")
        log(f"timing {k} {label} bounce {bounce} ({r['rays']} rays, {r['live']} live): kernel "
            f"{r['ms']:.4f} ms, plain twin {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}{walk}), at one FP32 instruction an operation "
            f"{r['bound_nc'][0]:.4f} ms")


def streamed_wave(device, tex_dir: str):
    """The first 8192 triangles of interior(detail=2) (64 tiles, every row
    real: above the rows K7 and K8 hold at once, so their tables stream)
    and two waves over them: the interior camera's at 512x512 (every 11th
    ray dead) and shadow rays from its hits toward points on the lights
    (their centres jittered by 0.05). Returns (tiles, closest rays,
    shadow rays)."""
    import numpy as np
    import torch

    from gatling_tpu_torch.ops import sampling as smp
    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf
    from gatling_tpu_torch.ops.geometry import SceneGeometry, build_geometry
    from gatling_tpu_torch.render.camera import camera_uniforms, generate_primary_rays
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(detail=2, tex_dir=tex_dir)
    paths = sorted({m.material for m in desc.meshes if m.material})
    midx = {p: i for i, p in enumerate(paths)}
    midx[None] = len(paths)
    geom = build_geometry(desc.meshes, midx)
    tiles = tt.build_tri_tiles(SceneGeometry(*[a[:8192] for a in geom]), device)
    n = SF_RES * SF_RES
    pix = torch.arange(n, device=device)
    o, d, _ = generate_primary_rays(camera_uniforms(desc.first_camera(), False, device), SF_RES,
                                    SF_RES, pix % SF_RES, pix // SF_RES, smp.rng_init(pix, 2),
                                    True, True, False)
    tmin = torch.zeros(n, device=device)
    tmax = torch.full((n,), 3.4e38, device=device)
    tmax[::11] = 0.0
    t, tri, _u, _v = trf.intersect_tiles_ref(o, d, tmin, tmax, tiles.tris)
    hit = tri >= 0
    rng = np.random.default_rng(4)
    centres = np.stack([np.asarray(lt.transform[3, :3]) for lt in desc.lights])
    target = centres[rng.integers(0, len(centres), size=n)] + rng.normal(scale=0.05, size=(n, 3))
    pos = o + d * torch.where(hit, t, 0.0)[:, None]
    to_light = torch.tensor(target, dtype=torch.float32, device=device) - pos
    dist = to_light.norm(dim=1)
    shadow = (pos.contiguous(), (to_light / dist[:, None]).contiguous(),
              torch.where(hit, 1e-3, 0.0), torch.where(hit, dist, 0.0))
    return tiles, (o, d, tmin, tmax), shadow


def phase_trace_streamed(device, tex_dir: str) -> dict:
    """Phase 3d on streamed_wave's 8192 triangles: K7's t, tri, u, v and
    K8's flags bit-equal to their twins on every ray, each timed with its
    bounds; the layout of K7 and K8 (rays a thread, lanes a shadow ray,
    rows held at once, rows a streamed chunk) logged."""
    import torch

    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf

    layout = tt.kernel().layout()
    log(f"K7/K8 layout {layout}")
    tiles, rays, shadow = streamed_wave(device, tex_dir)
    assert tiles.n_real > layout["resident_rows"], tiles.n_real
    label = f"interior{tiles.n_real}"
    got7, ref7 = tt.intersect_tiles(*rays, tiles), trf.intersect_tiles_ref(*rays, tiles.tris)
    got8 = tt.occluded_tiles(*shadow, tiles)
    first8 = trf.occluded_tiles_ref(*shadow, tiles.tris, first=True)
    torch.cuda.synchronize()
    bad7 = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
               for g, r in zip(got7, ref7))
    bad8 = int((got8 != (first8 >= 0)).sum())
    live = int((rays[3] > rays[2]).sum())
    log(f"parity {label} ({tiles.n_real} rows, streamed): closest ({rays[0].shape[0]} rays, "
        f"{live} live, {int((ref7[1] >= 0).sum())} hits) K7 {bad7} values not bit-equal to its "
        f"twin; shadow rays ({int((shadow[3] > shadow[2]).sum())} traced, {int(got8.sum())} "
        f"occluded) K8 {bad8} flags off its twin")
    assert bad7 == 0 and bad8 == 0
    n_real = tiles.n_real
    ops7, _ = tiles_ops("K7", label, rays, tiles, torch.full_like(ref7[1], n_real - 1))
    ops8, tested8 = tiles_ops("K8", label, shadow, tiles,
                              torch.where(first8 >= 0, first8, n_real - 1))
    log_k8_sweep(label, first8, shadow[3] > shadow[2], n_real, layout, tested8)
    results = {
        ("K7", label, 0): trace_timing(
            "K7", lambda: tt.intersect_tiles(*rays, tiles),
            lambda: trf.intersect_tiles_ref(*rays, tiles.tris), rays, tiles.rows, ops7, 0.0),
        ("K8", label, 0): trace_timing(
            "K8", lambda: tt.occluded_tiles(*shadow, tiles),
            lambda: trf.occluded_tiles_ref(*shadow, tiles.tris), shadow, tiles.rows, ops8, 0.0)}
    log_trace_times(results)
    return results


TRACE_ENTRIES = {
    "K5": ("intersect_matrix (K5, closest hit, coefficient form: intersect_tree_kernel, "
           "a walk of the soup's BVH)",
           "gatling_tpu/ops/pallas_trace.py:196 intersect_pallas -> _closest_hit_kernel :105"),
    "K6": ("occluded_matrix (K6, shadow rays, coefficient form: occluded_tree_kernel, "
           "an any-hit walk of the soup's BVH)",
           "gatling_tpu/ops/pallas_trace.py:235 occluded_pallas -> _occlusion_kernel :157"),
    "K7": ("intersect_tiles (K7, closest hit, elementwise)",
           "gatling_tpu/ops/pallas_trace.py:365 intersect_pallas_vpu -> "
           "_closest_hit_kernel_vpu :312"),
    "K8": ("occluded_tiles (K8, shadow rays, elementwise)",
           "gatling_tpu/ops/pallas_trace.py:401 occluded_pallas_vpu -> _occlusion_kernel_vpu :349"),
}


def trace_entry(kernel: str, times: dict, launches: int) -> dict:
    """The kernels-line entry of K5-K8: the headline numbers on the Cornell
    frame's bounce-0 wave, the other waves by case. K7 and K8 are on no
    path of either package (the JAX package's comparison point): their
    main-path launches are 0, and they run on the main path's waves."""
    name, replaces = TRACE_ENTRIES[kernel]
    head = times[(kernel, "cornell_aovs", 0)]
    cases = {f"{label}/bounce {b}": r for (k, label, b), r in sorted(times.items()) if k == kernel}
    brute = {}
    if kernel in ("K5", "K6"):  # the walk's bound and, beside it, brute force's
        brute = {"bound_ms_brute_force": head["bound_brute"][0],
                 "bound_ms_brute_force_by_case": {c: r["bound_brute"][0]
                                                  for c, r in cases.items()}}
    return {
        "name": name, "route": "cuda", "source": "gatling_tpu_torch/csrc/trace.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["err"] for r in cases.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": None,
        "on_main_path": kernel in ("K5", "K6"),
        "ms_by_case": {c: r["ms"] for c, r in cases.items()},
        "plain_ms_by_case": {c: r["plain_ms"] for c, r in cases.items()},
        "bound_ms_by_case": {c: r["bound"][0] for c, r in cases.items()},
        "bound_ms_no_contraction": head["bound_nc"][0],
        "bound_ms_no_contraction_by_case": {c: r["bound_nc"][0] for c, r in cases.items()},
        **brute,
    }


# ---------------------------------------------------------------------------
# 4l and 3i: the wavefront above 8192 triangles (B1/B2), dynamic inputs and
# backface materials
# ---------------------------------------------------------------------------

# operations of B1 and B2, counted from csrc/trace.cu: (a slab test, a
# triangle test) at the published f32 peak (a fused multiply-add two) and
# in FP32 instructions (a fused multiply-add one); 3 divisions a live ray
THREADED_FLOPS = {"B1": (26, 56), "B2": (25, 54)}
THREADED_INSTR = {"B1": (26, 42), "B2": (25, 40)}


def threaded_bound_ms(kernel: str, rays, bvh, work, nc: bool = False):
    """The least time of one B1 or B2 launch for the work its walk makes
    (trace_ref.threaded_work: slab tests, triangle tests): each ray's o, d,
    tmin, tmax read and its result (t, tri, u, v; a flag) written once, the
    node rows (8 words) and the triangles (v0, e1, e2: 9) read once (HBM),
    against THREADED_FLOPS at the published f32 peak, or with `nc`
    THREADED_INSTR at one FP32 instruction each."""
    n = rays[0].shape[0]
    live = int((rays[3] > rays[2]).sum())
    out_bytes = 16 if kernel == "B1" else 1
    slab, tri = (THREADED_INSTR if nc else THREADED_FLOPS)[kernel]
    nbytes = n * (32 + out_bytes) + 4 * (8 * bvh.num_nodes + 9 * bvh.tris.shape[0])
    return _bound(nbytes, 3 * live + work[0] * slab + work[1] * tri,
                  FP32_INSTR_RATE if nc else F32_FLOPS)


def threaded_parity(label: str, bounce, kind: str, rays, bvh) -> dict:
    """B1 (closest) or B2 (occluded) on one recorded wave against its twin
    over every ray: t, tri, u, v or the flags bit-equal. The twin's one run
    (trace_ref.threaded_work) gives its time, and the walk's work for the
    bound; the kernel is timed with CUDA events."""
    import torch

    from gatling_tpu_torch.ops import trace as tt
    from gatling_tpu_torch.ops import trace_ref as trf

    any_hit = kind == "occluded"
    k = "B2" if any_hit else "B1"
    run = tt.occluded_threaded if any_hit else tt.intersect_threaded
    got = run(*rays, bvh)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    ref, boxes, tests = trf.threaded_work(*rays, bvh, any_hit=any_hit)
    b.record()
    torch.cuda.synchronize()
    live = int((rays[3] > rays[2]).sum())
    if any_hit:
        bad = int((got != ref).sum())
        err = float((got != ref).float().max())
        what = f"{int(got.sum())} occluded"
    else:
        bad = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
                  for g, r in zip(got, ref))
        hit = ref[1] >= 0
        err = max(float((g[hit] - r[hit]).abs().max()) if bool(hit.any()) else 0.0
                  for g, r in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])))
        what = f"{int(hit.sum())} hits"
    work = (int(boxes.sum()), int(tests.sum()))
    log(f"parity {label} bounce {bounce} {kind} ({rays[0].shape[0]} rays, every one compared, "
        f"{live} live, {what}): {k} {bad} values not bit-equal to its twin; walk work {work} "
        f"slab and triangle tests, {work[0] / max(live, 1):.1f} and {work[1] / max(live, 1):.1f} "
        "a live ray")
    assert bad == 0, (label, bounce, kind)
    return dict(ms=event_ms(lambda: run(*rays, bvh)), plain_ms=a.elapsed_time(b),
                rays=rays[0].shape[0], live=live, err=err, work=work,
                bound=threaded_bound_ms(k, rays, bvh, work),
                bound_nc=threaded_bound_ms(k, rays, bvh, work, nc=True))


def timed_accel_build(params, label: str) -> float:
    """A first gi.render of `params` (timed_aov_render), which must build
    the wavefront's tracer: the seconds of that build (gi._build_accel:
    for the `bvh` tracer build_bvh on the host, the reorder, the device
    rows and the reordered packed rows)."""
    from gatling_tpu_torch import gi

    real, spent = gi._build_accel, []

    def timed(scene):
        t0 = time.perf_counter()
        real(scene)
        spent.append(time.perf_counter() - t0)

    gi._build_accel = timed
    try:
        timed_aov_render(params, label)
    finally:
        gi._build_accel = real
    assert len(spent) == 1, spent
    return spent[0]


def dynamic_eval_check(device) -> float:
    """eval_dynamic_expr of view_direction_material's emission on the card
    against the CPU, on 65,536 random view directions and normals: the
    largest difference (XLA-free torch ops on both sides; pow and the
    reductions may round differently on the two devices)."""
    import numpy as np
    import torch

    from gatling_tpu_torch.render.material import lower_material
    from gatling_tpu_torch.render.shadergraph import eval_dynamic_expr
    from gatling_tpu_torch.scene.examples import view_direction_material

    expr = lower_material(view_direction_material("/m")).dynamic["emissive"]
    rng = np.random.default_rng(8)
    vd, nrm = (torch.nn.functional.normalize(torch.tensor(rng.normal(size=(65536, 3)),
                                                          dtype=torch.float32), dim=1)
               for _ in range(2))
    cpu = eval_dynamic_expr(expr, vd, nrm)
    gpu = eval_dynamic_expr(expr, vd.to(device), nrm.to(device)).cpu()
    err = float((gpu - cpu).abs().max())
    log(f"dynamic input (view-direction emission) on the card against the CPU: max abs diff "
        f"{err:.3e} over 65536 hits")
    assert err < 1e-5
    return err


def phase_threaded(device, tex_dir: str, sf):
    """Phase 4l: the wavefront above 8192 triangles through gi.render, on
    the `bvh` tracer (B1 closest hits, B2 shadow rays): interior_aovs (the
    interior at full detail, 92,492 triangles) and sphere_field_aovs
    (294,916), every AOV, 512x512, 4 spp, 6 bounces, NEE; the tree's build
    time, a first and a warm frame, launches (B1 and B2 only), the AOV
    checks; then interior_dynamic (a view-dependent emission and a
    two-sided MDL material: the dynamic and backface routes), COLOR, its
    warm frame and image checks. Returns (frame numbers, each frame's B1
    and B2 launches, recorded waves and trees per scene)."""
    import numpy as np

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId, aov_bit
    from gatling_tpu_torch.scene.examples import interior_dynamic

    out, waves, launches_by = {}, {}, {}
    for label, params in (
            ("interior_aovs", interior_aovs_params(device, tex_dir, detail=5)),
            ("sphere_field_aovs", desc_params(device, sf[0], SF_RES, dict(
                spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True), every_aov=True))):
        desc = f"{label} {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee, every AOV"
        native_builds, real_build = [], gi.build_bvh

        def capture_build(v0, e1, e2, *args, _real=real_build, _into=native_builds):
            t0 = time.perf_counter()
            tree = _real(v0, e1, e2, *args)
            _into.append(((np.asarray(v0), np.asarray(e1), np.asarray(e2)), tree,
                          time.perf_counter() - t0))
            return tree

        gi.build_bvh = capture_build  # the native build and its soup, for 4n (e)
        try:
            t0 = time.perf_counter()
            build = timed_accel_build(params, desc + " (first frame)")
            first = time.perf_counter() - t0
        finally:
            gi.build_bvh = real_build
        scene = params.scene
        log(f"{label}: {scene._geom.num_triangles} triangles (padded), the threaded BVH's "
            f"{scene._accel.bvh.num_nodes} nodes built with the reorder and the device rows in "
            f"{build:.3f} s on the card's host; first frame {first:.3f} s")
        aovs, dt, launches = timed_aov_render(params, desc + " (warm)")
        assert scene._tracer == "bvh" and scene._fused is None and scene._accel.tables is None
        assert launches["B1"] > 0 and launches["B2"] > 0, launches
        assert all(launches[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")), \
            launches
        color = aovs[AovId.COLOR][..., :3]
        assert (color >= 0).all() and color.mean() > 0.01, label
        check_aovs(aovs, params, label)
        out[label] = dict(build_s=build, first_frame_s=first, warm_frame_s=dt,
                          triangles=scene._geom.num_triangles,
                          nodes=scene._accel.bvh.num_nodes, native_bvh=native_builds[0])
        launches_by[label] = {k: launches[k] for k in ("B1", "B2")}
        recorded = record_waves(params)
        if label == "sphere_field_aovs":
            out[label]["repeat"] = repeat_waves(recorded, record_waves(params), scene._accel.bvh,
                                                label)
            out[label]["repeat"]["fresh_nee_live"] = fresh_sphere_field_nee(device)
        waves[label] = (recorded, scene._accel.bvh)

    # interior_dynamic: a view-dependent emission and a two-sided MDL
    # material at full detail, COLOR only
    desc = interior_dynamic(tex_dir=tex_dir)
    params = desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                    nextEventEstimation=True))
    label = f"interior_dynamic {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee"
    counted_render(params, label + " (first frame)")
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, dt, _mr, launches = counted_render(params, label + " (warm)")
    scene = params.scene
    config = gi._build_config(params, SF_RES, SF_RES, aov_bit(AovId.COLOR))
    assert scene._tracer == "bvh" and scene._fused is None and config.has_backface
    assert [p for _i, p, _e in config.dynamic_params] == ["emissive"], config.dynamic_params
    assert launches["B1"] > 0 and launches["B2"] > 0, launches
    assert all(launches[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"))
    rgb = img[..., :3]
    assert np.isfinite(rgb).all() and (rgb >= 0).all() and rgb.mean() > 0.01, "interior_dynamic"
    log(f"interior_dynamic: warm frame {dt:.4f} s, COLOR mean {rgb.mean():.5f}, max "
        f"{rgb.max():.3f}; launches {launches}")
    out["interior_dynamic"] = dict(warm_frame_s=dt, color_mean=float(rgb.mean()),
                                   dynamic_eval_err=dynamic_eval_check(device),
                                   card_vs_cpu=interior_dynamic_card_vs_cpu(device, tex_dir))
    launches_by["interior_dynamic"] = {k: launches[k] for k in ("B1", "B2")}
    return out, launches_by, waves


def interior_dynamic_card_vs_cpu(device, tex_dir: str) -> dict:
    """interior_dynamic at 32x32, 1 spp, 3 bounces, NEE, COLOR and
    OBJECT_ID, on the card (B1/B2) and through the twins on the CPU, the
    same samples: the ids equal on 99 % of pixels, COLOR within 1e-3 on
    98 % and its mean within 1 % (tests/test_torch_wavefront.py's whole-
    frame tolerances)."""
    import numpy as np

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.scene.examples import interior_dynamic

    out = {}
    for dev in (device, "cpu"):
        desc = interior_dynamic(tex_dir=tex_dir)
        params = desc_params(dev, desc, 32, dict(spp=1, maxBounces=3, nextEventEstimation=True))
        params.aov_bindings.append(gi.GiAovBinding(AovId.OBJECT_ID,
                                                   gi.GiRenderBuffer(32, 32, 1, True), -1))
        t0 = time.perf_counter()
        gi.render(params)
        out[str(dev)] = [b.render_buffer.data.copy() for b in params.aov_bindings]
        log(f"interior_dynamic 32^2 on {dev}: {time.perf_counter() - t0:.2f} s")
    (cg, og), (cc, oc) = out[str(device)], out["cpu"]
    same = float((og == oc).mean())
    close = float((np.abs(cg - cc) <= 1e-3 + 1e-3 * np.abs(cc)).all(axis=-1).mean())
    rel = float(abs(cg[..., :3].mean() - cc[..., :3].mean()) / cc[..., :3].mean())
    log(f"interior_dynamic card vs CPU twins: ids equal on {same:.4f}, COLOR within 1e-3 on "
        f"{close:.4f}, mean rel diff {rel:.2e}")
    assert same >= 0.99 and close >= 0.98 and rel < 0.01
    return dict(ids_equal=same, color_close=close, mean_rel_diff=rel)


def repeat_waves(first: dict, second: dict, bvh, label: str) -> dict:
    """Two recordings of one scene's frame (record_waves) in one process:
    each wave's rays, its live (traced) count, and B1's hit rows or B2's
    flags on it must be bit-equal. (Two full runs of this script once
    logged two counts for sphere_field_aovs' bounce-0 NEE wave: a fresh
    sphere_field and the one that carries 4c's shift of a sphere group
    trace different waves; fresh_sphere_field_nee logs the former.)"""
    import torch

    from gatling_tpu_torch.ops import trace as tt

    out = {}
    for kind in ("closest", "occluded"):
        for bounce in sorted(first[kind]):
            a, b = first[kind][bounce], second[kind][bounce]
            live = [int((r[3] > r[2]).sum()) for r in (a, b)]
            rays_equal = all(torch.equal(x, y) for x, y in zip(a, b))
            run = tt.occluded_threaded if kind == "occluded" else tt.intersect_threaded
            ha, hb = run(*a, bvh), run(*b, bvh)
            hits_equal = (torch.equal(ha, hb) if kind == "occluded" else
                          all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                              for x, y in zip(ha, hb)))
            out[f"{kind} {bounce}"] = dict(live=live, rays_equal=rays_equal,
                                           hits_equal=hits_equal)
            log(f"{label} bounce {bounce} {kind} wave, recorded twice in one process: "
                f"{a[0].shape[0]} rays, live (traced) {live[0]} and {live[1]}, rays bit-equal "
                f"{rays_equal}, {'flags' if kind == 'occluded' else 'hit rows'} bit-equal "
                f"{hits_equal}")
            assert live[0] == live[1] and rays_equal and hits_equal, (label, kind, bounce)
    return out


def fresh_sphere_field_nee(device) -> int:
    """The live (traced) count of a fresh sphere_field's bounce-0 NEE wave
    at sphere_field_aovs' settings: the scene before 4c's transform edit,
    which the shared scene description keeps for the later phases."""
    from gatling_tpu_torch.scene.examples import sphere_field

    params = desc_params(device, sphere_field(), SF_RES, dict(
        spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True), every_aov=True)
    rays = record_waves(params, bounces=(0,))["occluded"][0]
    live = int((rays[3] > rays[2]).sum())
    log(f"sphere_field (fresh, before 4c's edit) bounce 0 occluded wave: {live} live (traced)")
    return live


def phase_threaded_trace(device, waves: dict, small) -> dict:
    """Phase 3i: B1 and B2 against their twins on 4l's recorded waves
    (bounces 0 and 2 of the first sample of interior_aovs; bounce 0 of
    sphere_field_aovs), every ray bit-equal, each timed with its bound;
    and on interior_aovs_small's waves (4e: interior(detail=1), 3,840
    triangles, traced there by K5/K6) over a threaded BVH of the same
    soup, beside K5 and K6 on the same rays: their times, and the hits
    (B1's triangle mapped back through the tree's order) against K5's."""
    import torch

    from gatling_tpu_torch.ops import bvh as bvhm
    from gatling_tpu_torch.ops import trace as tt

    results = {}
    for label, (recorded, bvh) in waves.items():
        keep = (0, 2) if label == "interior_aovs" else (0,)
        for kind in ("closest", "occluded"):
            for bounce, rays in recorded[kind].items():
                if bounce in keep:
                    k = "B2" if kind == "occluded" else "B1"
                    results[(k, label, bounce)] = threaded_parity(label, bounce, kind, rays, bvh)
    recorded, tables, geom = small
    t0 = time.perf_counter()
    arrays, order = bvhm.build_bvh(geom.v0, geom.e1, geom.e2)
    bvh = bvhm.threaded_bvh(arrays, bvhm.reorder_geometry(geom, order), device)
    log(f"interior_aovs_small: threaded BVH over {geom.num_triangles} triangles in "
        f"{time.perf_counter() - t0:.3f} s")
    order_t = torch.as_tensor(order, device=device)
    for kind in ("closest", "occluded"):
        for bounce, rays in recorded[kind].items():
            k = "B2" if kind == "occluded" else "B1"
            r = threaded_parity("interior_aovs_small", bounce, kind, rays, bvh)
            if kind == "closest":
                k5 = tt.intersect_matrix(*rays, tables)
                b1 = tt.intersect_threaded(*rays, bvh)
                mapped = torch.where(b1.tri >= 0, order_t[b1.tri.clamp(min=0).long()], -1)
                r["same_hit_as_k5"] = float((mapped == k5.tri).float().mean())
                r["k5_ms"] = event_ms(lambda rr=rays: tt.intersect_matrix(*rr, tables))
            else:
                r["same_hit_as_k5"] = float((tt.occluded_matrix(*rays, tables)
                                             == tt.occluded_threaded(*rays, bvh)).float().mean())
                r["k5_ms"] = event_ms(lambda rr=rays: tt.occluded_matrix(*rr, tables))
            log(f"interior_aovs_small bounce {bounce} {kind}: {k} {r['ms']:.4f} ms, "
                f"{'K5' if k == 'B1' else 'K6'} {r['k5_ms']:.4f} ms on the same rays; the same "
                f"answer on {r['same_hit_as_k5']:.6f} of rays")
            assert r["same_hit_as_k5"] >= 0.999
            results[(k, "interior_aovs_small", bounce)] = r
    for (k, label, bounce), r in sorted(results.items()):
        log(f"timing {k} {label} bounce {bounce} ({r['rays']} rays, {r['live']} live): kernel "
            f"{r['ms']:.4f} ms, plain twin {r['plain_ms']:.1f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}; walk work {r['work']}), at one FP32 instruction an operation "
            f"{r['bound_nc'][0]:.4f} ms")
    return results


THREADED_ENTRIES = {
    "B1": ("intersect_threaded (B1, closest hit: threaded_closest_kernel, a stackless walk of "
           "the threaded BVH, the wavefront's tracer above 8192 triangles)",
           "gatling_tpu/ops/bvh.py:202 traverse (any_hit=False; an XLA lax.while_loop, no "
           "Pallas kernel) via traverse_closest :266"),
    "B2": ("occluded_threaded (B2, shadow rays: threaded_occluded_kernel, its any-hit walk)",
           "gatling_tpu/ops/bvh.py:202 traverse (any_hit=True; an XLA lax.while_loop, no "
           "Pallas kernel) via traverse_occluded :270"),
}


def threaded_entry(kernel: str, times: dict, launches: dict, frames: dict,
                   formats: dict) -> dict:
    """The kernels-line entry of B1 or B2: the headline numbers on
    interior_aovs' bounce-0 wave (its launches a warm frame), the other
    waves by case, K5's or K6's time beside it on interior_aovs_small; the
    trees' host builds (4l, the native library) and 4n's NumPy twin's."""
    name, replaces = THREADED_ENTRIES[kernel]
    head = times[(kernel, "interior_aovs", 0)]
    cases = {f"{label}/bounce {b}": r for (k, label, b), r in sorted(times.items())
             if k == kernel}
    return {
        "name": name, "route": "cuda", "source": "gatling_tpu_torch/csrc/trace.cu",
        "replaces": replaces, "launches": launches["interior_aovs"][kernel],
        "max_abs_err": max(r["err"] for r in cases.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": None, "on_main_path": True,
        "launches_by_frame": {label: v[kernel] for label, v in launches.items()},
        "walk_work": head["work"],
        "ms_by_case": {c: r["ms"] for c, r in cases.items()},
        "plain_ms_by_case": {c: r["plain_ms"] for c, r in cases.items()},
        "bound_ms_by_case": {c: r["bound"][0] for c, r in cases.items()},
        "bound_ms_no_contraction": head["bound_nc"][0],
        "bound_ms_no_contraction_by_case": {c: r["bound_nc"][0] for c, r in cases.items()},
        "walk_work_by_case": {c: r["work"] for c, r in cases.items()},
        ("k5_ms_by_case" if kernel == "B1" else "k6_ms_by_case"): {
            c: r["k5_ms"] for c, r in cases.items() if "k5_ms" in r},
        "bvh_build_s": {label: f["build_s"] for label, f in frames.items() if "build_s" in f},
        "bvh_build_native_s": {k: v["native_s"] for k, v in formats["bvh"].items()},
        "bvh_build_numpy_twin_s": {k: v["twin_s"] for k, v in formats["bvh"].items()},
    }


# ---------------------------------------------------------------------------
# 4f, 3e and P: glass, clearcoat, anisotropy and cutout; the probes
# ---------------------------------------------------------------------------

GLASS = os.path.join(HERE, "tests", "graphical", "Materials.GlassCoated", "scene.usda")
# the bench's glass_coated frame (bench.py:40-54, :365-369) and the Cornell one
LOBES_RES, LOBES_SPP, LOBES_BOUNCES = FULL_RES, 16, 8
OPEN_PBR = "ND_open_pbr_surface_surfaceshader"


def merged_settings(desc, **overrides) -> dict:
    """The defaults, a scene file's render settings and `overrides`, as the
    CLI merges them."""
    from gatling_tpu_torch.utils.config import default_settings

    s = default_settings()
    s["metersPerSceneUnit"] = desc.meters_per_unit
    s.update(desc.render_settings)
    s.update(overrides)
    return s


def desc_params(device, desc, res: int, settings: dict, every_aov: bool = False):
    """gi render parameters of a scene description on a new GiScene: COLOR,
    or every AOV."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId

    scene = gi.create_scene(device)
    for m in desc.meshes:
        scene.add_mesh(m)
    for m in desc.materials.values():
        scene.add_material(m)
    for light in desc.lights:
        scene.add_light(light)
    binds = (all_aov_bindings(res, res) if every_aov
             else [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(res, res, 4))])
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                             render_settings=settings)


def surface_variant(mat, shader_id: str | None = None, **inputs):
    """A copy of a material whose surface node takes `shader_id` (default:
    its own) and `inputs` over its own; its connections (textures) stay."""
    import copy

    out = copy.deepcopy(mat)
    node = out.nodes[out.surface_node]
    if shader_id is not None:
        node.shader_id = shader_id
    node.inputs.update(inputs)
    return out


def glass_coated_params(device, nee: bool):
    """glass_coated: Materials.GlassCoated at the bench's settings, 1200²,
    16 spp, 8 bounces (NEE off as bench.py sets it; on as the scene asks)."""
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(GLASS)
    return desc_params(device, desc, LOBES_RES, merged_settings(
        desc, spp=LOBES_SPP, maxBounces=LOBES_BOUNCES, nextEventEstimation=nee))


def cornell_cutout_desc():
    """The Cornell box with the bench's rect light; the tall block's new
    white material has opacity 0.5 (stochastic cutout), the short block's
    opacity 0.3 under opacityThreshold 0.5 (a binary cutout: it vanishes)."""
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(CORNELL)
    white = desc.materials["/Cornell/Materials/White"]
    for block, extra in (("TallBlock", dict(opacity=0.5)),
                         ("ShortBlock", dict(opacity=0.3, opacityThreshold=0.5))):
        path = f"/Cornell/Materials/{block}Cutout"
        desc.materials[path] = surface_variant(white, **extra)
        desc.materials[path].path = path
        next(m for m in desc.meshes if m.path.endswith("/" + block)).material = path
    desc.lights.append(bench_rect_light())
    return desc


def cornell_cutout_params(device, every_aov: bool = False):
    desc = cornell_cutout_desc()
    return desc_params(device, desc, LOBES_RES, merged_settings(
        desc, spp=LOBES_SPP, maxBounces=LOBES_BOUNCES, nextEventEstimation=True), every_aov)


def sphere_field_lobes_desc():
    """sphere_field with /mat0 an open_pbr thick glass, /mat1 a clearcoated
    UsdPreviewSurface and /mat2 a UsdPreviewSurface of opacity 0.5."""
    from gatling_tpu_torch.scene.examples import sphere_field

    desc = sphere_field()
    m = desc.materials
    m["/mat0"] = surface_variant(m["/mat0"], OPEN_PBR, transmission_weight=1.0,
                                 specular_ior=1.5, specular_roughness=0.0,
                                 base_color=(1.0, 1.0, 1.0))
    m["/mat1"] = surface_variant(m["/mat1"], clearcoat=1.0)
    m["/mat2"] = surface_variant(m["/mat2"], opacity=0.5)
    return desc


def sphere_field_lobes_params(device, desc, nee: bool):
    return desc_params(device, desc, SF_RES, merged_settings(
        desc, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=nee))


def interior_lobes_params(device, tex_dir: str):
    """interior_lobes: the interior at its bench settings with the worktop
    an open_pbr surface (its marble texture as base colour, specular
    roughness anisotropy 0.6) and the instanced bowls at opacity 0.5 over
    their fabric texture."""
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(tex_dir=tex_dir)
    m = desc.materials
    work = m["/m_worktop"]
    node = work.nodes[work.surface_node]
    tex = node.input_connections.pop("diffuseColor")
    m["/m_worktop"] = surface_variant(work, OPEN_PBR, specular_roughness=0.25,
                                      specular_roughness_anisotropy=0.6)
    m["/m_worktop"].nodes[work.surface_node].input_connections["base_color"] = tex
    m["/m_bowl"] = surface_variant(m["/m_bowl"], opacity=0.5)
    return desc_params(device, desc, SF_RES, merged_settings(
        desc, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True))


def first_and_warm(params, label, want: set, warm_frames: int = 1):
    """A first frame (scene build included) and warm frames of the same
    samples; the launches of the last must be those of `want` only.
    Returns (image, {first, warm seconds, Mray/s}, launches)."""
    from gatling_tpu_torch import gi

    _img, first, _mr, _l = counted_render(params, label + " (first frame)")
    warm, rates = [], []
    for i in range(warm_frames):
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, mr, launches = counted_render(params, label + f" (warm {i + 1})")
        warm.append(dt)
        rates.append(mr)
    assert all(launches[k] > 0 for k in want), (label, launches)
    assert all(v == 0 for k, v in launches.items() if k not in want), (label, launches)
    return img, dict(first_s=first, warm_s=warm, mrays=rates), launches


def record_fused_waves(run, bounces=(0, 2)):
    """Run one frame (`run()`) with the fused path's kernel calls recorded:
    for the first sample batch, the params row and the state going into
    each bounce of `bounces`, and for the split bounce the hit buffer, the
    device material table and the texture pool K4 was handed. Returns
    ({bounce: (params row, state, None or (hit buffer, materials, pool))},
    what run returned)."""
    with KernelCalls(max(bounces) + 1, ("bounce_step", "shade_step")) as kc:
        result = run()
    calls = [(a[0], a[2], None if name == "bounce_step" else (a[3], a[4], a[5]))
             for name, a in kc.calls]
    return {b: calls[b] for b in bounces if b < len(calls)}, result


def gi_frame(params):
    """A function that renders one more frame of `params` through gi."""
    from gatling_tpu_torch import gi

    def run():
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        gi.render(params)
    return run


def flattened_frame(params):
    """(flattened tables, static, a function rendering the frame of
    `params` through them with render_pixels_fused) for a scene that
    gi.render rendered on instance tables."""
    import torch

    from gatling_tpu_torch.render.camera import camera_uniforms
    from gatling_tpu_torch.render.fused import render_pixels_fused
    from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms

    fs, static, *_rest = split_tables(params, flattened=True)
    assert static.clustered and not static.instanced
    if params.scene._fused_static.volumes:  # the frame's volume mode (gi._fused_volumes)
        from gatling_tpu_torch.ops.bounce import with_volumes

        fs, static = with_volumes(fs, static, params.scene._fused_static.scatter)
    s, device = params.render_settings, params.scene.device
    res = params.aov_bindings[0].render_buffer.width
    cfg = RenderConfig(width=res, height=res, spp=s["spp"], max_bounces=s["maxBounces"],
                       nee=bool(s["nextEventEstimation"]))
    uni = Uniforms(camera=camera_uniforms(params.camera, False, device), sample_offset=0,
                   inv_total_sample_count=1.0 / s["spp"], max_sample_value=10.0,
                   rr_inv_min_term_prob=0.95, light_intensity_multiplier=1.0,
                   meters_per_scene_unit=1.0, max_volume_walk_length=7)
    pix = torch.arange(res * res, device=device)
    return fs, static, lambda: render_pixels_fused(cfg, uni, fs, pix, s["spp"], 0).cpu().numpy()


def cutout_pass_rate(params):
    """On cornell_cutout's first wave (1200² x 2 samples): the share of the
    camera rays whose first surface is the tall block (opacity 0.5) that
    pass it, and the camera rays that hit the short block (opacity 0.3
    under threshold 0.5), from the kernels' tables through the twin's
    search with and without the cutout draws."""
    import torch

    from gatling_tpu_torch.ops.bounce_ref import (P_TMIN, TR_MAT, closest_hit, cutout_key)

    scene = params.scene
    fs = scene._fused
    wave = wave_state(params.camera, LOBES_RES, LOBES_RES, 2, scene.device)
    o, d = (wave[0], wave[1], wave[2]), (wave[3], wave[4], wave[5])
    tmin = float(params_row(0, scene.device)[P_TMIN])
    _t, _u, _v, win = closest_hit(fs.tris, o, d, tmin)
    t_cut, _u, _v, win_cut = closest_hit(fs.tris, o, d, tmin, cutout_key(wave))
    mat = lambda w: torch.where(w >= 0, fs.tris[w.clamp(min=0), TR_MAT], -1.0)
    idx = scene._material_index
    tall = mat(win) == idx["/Cornell/Materials/TallBlockCutout"]
    passed = tall & (win_cut != win)
    short_hits = int((mat(win_cut) == idx["/Cornell/Materials/ShortBlockCutout"]).sum())
    short_before = int((mat(win) == idx["/Cornell/Materials/ShortBlockCutout"]).sum())
    rate = float(passed.sum()) / max(int(tall.sum()), 1)
    log(f"cornell_cutout first wave: {int(tall.sum())} camera rays meet the tall block first, "
        f"{rate:.5f} of them pass it (opacity 0.5); the short block (0.3 < threshold 0.5) "
        f"stops {short_hits} rays ({short_before} without cutout)")
    return rate, short_hits, short_before


def golden_glass_coated(device):
    """Materials.GlassCoated at its own settings (96², 48 spp, 6 bounces,
    NEE) through gi on the card, against its committed reference. The
    reference is a wavefront image (the JAX package's harness renders it on
    the CPU): the frame with an OBJECT_ID binding beside COLOR takes the
    port's wavefront and must pass the scene's gtl:errorPixelThreshold and
    gtl:flipThreshold. The COLOR frame alone takes the fused K1 with the
    advanced lobes, whose samples are drawn in another order: it is held to
    the FLIP threshold and its mean to 2 % of the reference's, and its
    error components are reported."""
    import numpy as np

    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.scene.stage import load_scene
    from gatling_tpu_torch.testing import compare_images, encode_aov_u8

    desc = load_scene(GLASS)
    s = merged_settings(desc)
    ref = imgio.load_image_file(os.path.join(os.path.dirname(GLASS), "ref_color.png"))
    out = {}
    for route in ("wavefront", "fused"):
        params = desc_params(device, desc, 96, s)
        if route == "wavefront":
            params.aov_bindings.append(gi.GiAovBinding(
                AovId.OBJECT_ID, gi.GiRenderBuffer(96, 96, 1, True), clear_value=-1))
        gi.render(params)
        scene = params.scene
        assert (scene._fused is None) == (route == "wavefront"), route
        color = params.aov_bindings[0].render_buffer.data
        img = encode_aov_u8(AovId.COLOR, color[::-1])
        errors, flip, _msgs = compare_images("color", img, ref, int(s["errorPixelThreshold"]),
                                             float(s["flipThreshold"]))
        rel = abs(img[..., :3].mean() / ref[..., :3].mean() - 1.0)
        log(f"Materials.GlassCoated on the card, {route}: {errors} error components (threshold "
            f"{s['errorPixelThreshold']}), mean FLIP {flip:.4f} (threshold {s['flipThreshold']}), "
            f"mean encoded value {rel:.4f} off the reference's")
        assert np.isfinite(color).all() and flip <= float(s["flipThreshold"]), route
        if route == "wavefront":
            assert errors <= int(s["errorPixelThreshold"])
        else:
            assert scene._fused_static.advanced and rel < 0.02
        out[route] = dict(errors=errors, flip=flip, mean_rel=rel)
    return out


def phase_lobes(device, tex_dir: str):
    """Phase 4f: configurations 1-5 of the advanced lobes and cutout through
    gi.render, each a first and a warm frame with its launch counts and
    checks; the GlassCoated golden; the cutout pass rate. Returns (frame
    numbers, launches a frame, {case: (fused scene, static, recorded
    waves, nee)} for 3e)."""
    import numpy as np

    from gatling_tpu_torch.interface import AovId

    out, launches, replay = {}, {}, {}
    for nee in (False, True):
        label = f"glass_coated{'_nee' if nee else ''}"
        params = glass_coated_params(device, nee)
        img, out[label], lc = first_and_warm(
            params, f"{label} {LOBES_RES}^2 {LOBES_SPP}spp {LOBES_BOUNCES} bounces", {"K1"})
        st = params.scene._fused_static
        assert st.advanced and not st.cutout and not st.clustered and not st.textured
        img = img[..., :3]
        assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.01, label
        launches[label] = lc["K1"]
        replay[label] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0], nee)
    out["glass_coated_golden"] = golden_glass_coated(device)

    params = cornell_cutout_params(device)
    img, out["cornell_cutout"], lc = first_and_warm(
        params, f"cornell_cutout {LOBES_RES}^2 {LOBES_SPP}spp {LOBES_BOUNCES} bounces nee",
        {"K1"})
    st = params.scene._fused_static
    assert st.cutout and not st.advanced and not st.clustered
    image_checks(img, "cornell_cutout")
    launches["cornell_cutout"] = lc["K1"]
    rate, short_hits, short_before = cutout_pass_rate(params)
    assert abs(rate - 0.5) <= 0.01 and short_hits == 0 and short_before > 0
    out["cornell_cutout_pass_rate"] = rate
    replay["cornell_cutout"] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0],
                                True)

    desc = sphere_field_lobes_desc()
    imgs = {}
    for nee in (False, True):
        label = f"sphere_field_lobes{'_nee' if nee else ''}"
        params = sphere_field_lobes_params(device, desc, nee)
        img, out[label], lc = first_and_warm(
            params, f"{label} {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces", {"K2"})
        st = params.scene._fused_static
        assert st.instanced and st.advanced and st.cutout and not st.textured
        imgs[nee] = img[..., :3]
        assert np.isfinite(imgs[nee]).all() and (imgs[nee] >= 0).all(), label
        launches[label] = lc["K2"]
        replay[label] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0], nee)
    # the NEE frame through the flattened tables: other triangle ids, so
    # other cutout draws; the means agree
    flat, fstat, run = flattened_frame(params)
    waves, flat_img = record_fused_waves(run)
    replay["sphere_field_lobes_nee_flattened"] = (flat, fstat, waves, True)
    assert imgs[True].mean() > imgs[False].mean() * 1.02, "NEE must add light"
    rel = abs(flat_img.mean() - imgs[True].mean()) / imgs[True].mean()
    log(f"sphere_field_lobes instanced vs flattened (NEE): mean rel diff {rel:.3e}")
    assert np.isfinite(flat_img).all() and rel < 0.01, rel
    out["sphere_field_lobes_flattened_rel"] = rel

    params = interior_lobes_params(device, tex_dir)
    img, out["interior_lobes"], lc = first_and_warm(
        params, f"interior_lobes {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee", {"K3", "K4"})
    st = params.scene._fused_static
    assert st.instanced and st.textured and st.advanced and st.cutout and st.tangents
    img = img[..., :3]
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.01
    launches["interior_lobes"] = {k: lc[k] for k in ("K3", "K4")}
    replay["interior_lobes"] = (params.scene._fused, st, record_fused_waves(gi_frame(params))[0],
                                True)

    # the wavefront: K5 traces the camera rays and, hop by hop, the shadow
    # rays through the cutout (render/integrator.py _trace_occluded_cutout,
    # as the JAX wavefront does), so K6 is not launched
    params = cornell_cutout_params(device, every_aov=True)
    aovs, out["cornell_cutout_aovs"], lc = first_and_warm(
        params, f"cornell_cutout_aovs {LOBES_RES}^2 {LOBES_SPP}spp {LOBES_BOUNCES} bounces nee, "
        "every AOV", {"K5"})
    assert params.scene._accel is not None and params.scene._fused is None
    full = {b.aov_id: b.render_buffer.data.copy() for b in params.aov_bindings}
    image_checks(full[AovId.COLOR], "cornell_cutout_aovs")
    check_aovs(full, params, "cornell_cutout_aovs")
    launches["cornell_cutout_aovs"] = {"K5": lc["K5"]}
    hops = record_hop_waves(params)
    log(f"cornell_cutout_aovs: recorded the shadow hop waves {sorted(hops)}")
    assert hops
    hop_waves = {"cornell_cutout_aovs_hops": ({"closest": hops, "occluded": {}},
                                              params.scene._accel.tables, params.scene._geom)}
    return out, launches, replay, hop_waves


# ---------------------------------------------------------------------------
# 4g and 3f: media (the MDL front end, the volume branches, the medium stack)
# ---------------------------------------------------------------------------

# cornell_fog's fused frame (the scatter mode) against the wavefront's at
# mediumStackSize 1: per-channel means within this share. Set before the
# first card run from the CPU comparison (tests/test_torch_volumes.py: 0.24-
# 0.33 % at 64x64 and 0.01-0.08 % at 128x128, 16 spp, falling with the
# sample count as noise does); 1200x1200 at 16 spp has 88x the samples.
FOG_MEAN_TOL = 0.005
# the slab's Beer-Lambert value 2 exp(-2 sigma) at its centre pixel
SLAB_SIGMA, SLAB_RTOL = (0.5, 1.0, 2.0), 0.05


def media_params(device, desc, res: int, spp: int, bounces: int, stack: int, nee: bool = True,
                 every_aov: bool = False):
    return desc_params(device, desc, res, merged_settings(
        desc, spp=spp, maxBounces=bounces, nextEventEstimation=nee, mediumStackSize=stack,
        maxVolumeWalkLength=7), every_aov)


def media_frame(params, label, want: set, mode):
    """first_and_warm with the checks of a fused media frame: finite,
    non-negative, lit, and the volume mode `mode` on gi's tables (None: the
    wavefront)."""
    import numpy as np

    img, frames, lc = first_and_warm(params, label, want)
    scene = params.scene
    if mode is None:
        assert scene._fused is None and scene._accel is not None, label
    else:
        assert scene._fused.volumes == mode and scene._fused_static.volumes, label
    rgb = img[..., :3]
    assert np.isfinite(rgb).all() and (rgb >= 0).all() and 0.01 < rgb.mean() < 5.0, label
    frames["mean"] = [float(x) for x in rgb.reshape(-1, 3).mean(0)]
    return img, frames, lc


def slab_check(device):
    """The slab of tests/test_volumes.py (examples.absorbing_slab) at 8x8
    through gi's fused path on the card, stack 0 (K1's absorption branch)
    and 1 (the scatter mode): the centre pixel 2 exp(-2 sigma) within 5 %."""
    import numpy as np

    from gatling_tpu_torch.scene.examples import absorbing_slab

    out = {}
    want = 2.0 * np.exp(-2.0 * np.asarray(SLAB_SIGMA))
    for stack in (0, 1):
        desc = absorbing_slab(SLAB_SIGMA)
        params = desc_params(device, desc, 8, merged_settings(
            desc, spp=1, maxBounces=6, jitteredSampling=False, filterImportanceSampling=False,
            rrBounceOffset=100, mediumStackSize=stack))
        _img, _dt, _mr, lc = counted_render(params, f"slab stack {stack}")
        c = params.aov_bindings[0].render_buffer.data[4, 4, :3]
        rel = np.abs(c / want - 1.0)
        log(f"slab stack {stack}: centre {c.tolist()} against 2 exp(-2 sigma) {want.tolist()}, "
            f"rel err {rel.tolist()}")
        assert lc["K1"] > 0 and params.scene._fused.volumes == stack + 1
        assert (rel <= SLAB_RTOL).all(), (stack, rel)
        out[f"stack{stack}_rel_err"] = float(rel.max())
    return out


def phase_volumes(device, tex_dir: str):
    """Phase 4g: the media configurations through gi.render, each a first
    and a warm frame with its launches and checks: glass_tinted (also one
    frame through the CLI on the written .usda), cornell_fog (and its
    wavefront frame at stack 1, compared in distribution), cornell_fog at
    stack 2 (the wavefront's medium stack), sphere_field_volumes (stack 1,
    NEE off and on, and the NEE frame through the flattened tables; stack
    0), interior_tinted; the slab's Beer-Lambert value. Returns (frame
    numbers, launches a frame, {case: (tables, static, recorded waves, nee)}
    for 3f)."""
    import numpy as np

    from gatling_tpu_torch import cli, gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.scene import examples as ex
    from gatling_tpu_torch.scene.stage import load_scene

    out, launches, replay = {}, {}, {}
    res, spp, bnc = LOBES_RES, LOBES_SPP, LOBES_BOUNCES

    # glass_tinted: OmniGlass through info:mdl:sourceAsset, K1's absorption
    # branch on the advanced instance; one frame through the CLI
    glass_usda = ex.glass_tinted(tex_dir)
    png = os.path.join(tex_dir, "glass_tinted.png")
    for k in tb.launches:
        tb.launches[k] = 0
    t0 = time.perf_counter()
    rc = cli.main([glass_usda, png, "--image-width", str(res), "--image-height", str(res),
                   "--spp", str(spp), "--max-bounces", str(bnc), "--next-event-estimation",
                   "--medium-stack-size", "0", "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    cli_img = imgio.load_image_file(png)
    log(f"glass_tinted through the CLI: rc {rc}, {cli_s:.2f} s, K1 launches {tb.launches['K1']}, "
        f"{cli_img.shape} image, mean {cli_img[..., :3].mean():.4f}")
    assert rc == 0 and tb.launches["K1"] > 0 and cli_img[..., :3].mean() > 0.01
    out["glass_tinted_cli_s"] = cli_s
    params = media_params(device, load_scene(glass_usda), res, spp, bnc, 0)
    img, out["glass_tinted"], lc = media_frame(
        params, f"glass_tinted {res}^2 {spp}spp {bnc} bounces nee", {"K1"}, tb.VOL_ABSORB)
    image_checks(img, "glass_tinted")
    assert params.scene._fused_static.advanced and not params.scene._fused_static.clustered
    launches["glass_tinted"] = lc["K1"]
    replay["glass_tinted"] = (params.scene._fused, params.scene._fused_static,
                              record_fused_waves(gi_frame(params))[0], True)

    # cornell_fog: the MDL fog at stack 1, K1's scatter branch
    fog_desc = load_scene(ex.cornell_fog(tex_dir))
    params = media_params(device, fog_desc, res, spp, bnc, 1)
    img, out["cornell_fog"], lc = media_frame(
        params, f"cornell_fog {res}^2 {spp}spp {bnc} bounces nee stack 1", {"K1"},
        tb.VOL_SCATTER)
    image_checks(img, "cornell_fog")
    launches["cornell_fog"] = lc["K1"]
    replay["cornell_fog"] = (params.scene._fused, params.scene._fused_static,
                             record_fused_waves(gi_frame(params))[0], True)
    # the same frame through the wavefront (an OBJECT_ID binding: gi's own rule)
    wave = media_params(device, fog_desc, res, spp, bnc, 1)
    wave.aov_bindings.append(gi.GiAovBinding(AovId.OBJECT_ID, gi.GiRenderBuffer(res, res, 1, True),
                                             clear_value=-1))
    wimg, _dt, _mr, wl = counted_render(wave, "cornell_fog wavefront stack 1")
    assert wave.scene._fused is None and wl["K5"] > 0 and wl["K1"] == 0
    fm, wm = img[..., :3].reshape(-1, 3).mean(0), wimg[..., :3].reshape(-1, 3).mean(0)
    gap = np.abs(fm / wm - 1.0)
    log(f"cornell_fog fused against wavefront (stack 1): means {fm.tolist()} / {wm.tolist()}, "
        f"per-channel gap {gap.tolist()} (tolerance {FOG_MEAN_TOL})")
    assert (gap <= FOG_MEAN_TOL).all(), gap
    out["cornell_fog_vs_wavefront_gap"] = [float(g) for g in gap]

    # cornell_fog_stack2: the wavefront's medium stack, K5 and K6 only
    params = media_params(device, fog_desc, res, spp, bnc, 2)
    img, out["cornell_fog_stack2"], lc = media_frame(
        params, f"cornell_fog_stack2 {res}^2 {spp}spp {bnc} bounces nee", {"K5", "K6"}, None)
    image_checks(img, "cornell_fog_stack2")
    launches["cornell_fog_stack2"] = {k: lc[k] for k in ("K5", "K6")}

    # sphere_field_volumes: K2's scatter branch (stack 1, NEE off and on,
    # instanced; the NEE frame flattened) and its absorption branch (stack 0)
    desc = ex.sphere_field_volumes(tex_dir)
    imgs = {}
    for stack, nee in ((1, False), (1, True), (0, True)):
        label = f"sphere_field_volumes{'_nee' if nee else ''}{'_stack0' if stack == 0 else ''}"
        params = media_params(device, desc, SF_RES, SF_SPP, SF_BOUNCES, stack, nee)
        img, out[label], lc = media_frame(
            params, f"{label} {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces", {"K2"},
            tb.VOL_SCATTER if stack else tb.VOL_ABSORB)
        assert params.scene._fused_static.instanced and params.scene._fused_static.advanced
        imgs[(stack, nee)] = img[..., :3]
        launches[label] = lc["K2"]
        replay[label] = (params.scene._fused, params.scene._fused_static,
                         record_fused_waves(gi_frame(params))[0], nee)
        if (stack, nee) == (1, True):
            flat, fstat, run = flattened_frame(params)
            waves, flat_img = record_fused_waves(run)
            assert flat.volumes == tb.VOL_SCATTER
            replay["sphere_field_volumes_nee_flattened"] = (flat, fstat, waves, True)
            rel = abs(flat_img.mean() - imgs[(1, True)].mean()) / imgs[(1, True)].mean()
            log(f"sphere_field_volumes instanced vs flattened (NEE): mean rel diff {rel:.3e}")
            assert np.isfinite(flat_img).all() and rel < 0.01, rel
            out["sphere_field_volumes_flattened_rel"] = rel
    assert imgs[(1, True)].mean() > imgs[(1, False)].mean() * 1.02, "NEE must add light"

    # interior_tinted: the instanced bowls in tinted OmniGlass, K3 + K4's
    # absorption branch
    desc = ex.interior_tinted(tex_dir=tex_dir)
    params = media_params(device, desc, SF_RES, SF_SPP, SF_BOUNCES, 0)
    img, out["interior_tinted"], lc = media_frame(
        params, f"interior_tinted {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee",
        {"K3", "K4"}, tb.VOL_ABSORB)
    st = params.scene._fused_static
    assert st.instanced and st.textured and st.advanced
    launches["interior_tinted"] = {k: lc[k] for k in ("K3", "K4")}
    replay["interior_tinted"] = (params.scene._fused, st,
                                 record_fused_waves(gi_frame(params))[0], True)

    out["slab"] = slab_check(device)
    return out, launches, replay



def bounce_twin(p, fs, state, nee):
    """The twin of bounce_step on fused tables fs (resident or walk)."""
    from gatling_tpu_torch.ops.bounce_ref import bounce_ref

    bounce_ref(p, fs.tris, fs.mats, fs.lights, tuple(fs.light_types.tolist()), state, nee,
               fs.walk, fs.advanced, fs.cutout, fs.volumes)


def check_parity(label, got, twin, errs, exact: bool = False):
    """compare() with the branches' criteria: rows 12-15 bit-equal and rows
    0-11 within rtol/atol, each on at least MIN_AGREE of the rays (with
    `exact`, rows 12-15 on every ray)."""
    bad_bits, outside, n, err = compare(got, twin)
    log(f"parity {label}: {bad_bits} rays with rows 12-15 not bit-equal, {outside} of {n} "
        f"rays outside rtol {RTOL}/atol {ATOL} on rows 0-11, max abs err {err:.3g}")
    assert bad_bits <= (0 if exact else n * (1 - MIN_AGREE)), (label, bad_bits)
    assert outside <= n * (1 - MIN_AGREE), (label, outside)
    errs.append(err)


def check_draws(label, wave, fs):
    """The kernels' cutout draws (ops/bounce.py cutout_draws) against the
    twin's cutout_xi, bit for bit, for every ray of a wave: its camera key
    against each of 64 triangle ids spread over the table, and its
    shadow key against the same ids."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import SHADOW_SALT, cutout_key, cutout_xi

    key = cutout_key(wave)
    n_ids = fs.tris.shape[0]
    ids = torch.linspace(0, n_ids - 1, 64, device=wave.device).long()
    bad = 0
    for k in (key, key ^ SHADOW_SALT):
        kk = k[:, None].expand(-1, ids.numel()).reshape(-1)
        ii = ids[None, :].expand(k.numel(), -1).reshape(-1)
        i32 = lambda x: (x - ((x >> 31) << 32)).to(torch.int32)  # uint32 bits as int32
        got = tb.cutout_draws(i32(kk).contiguous(), i32(ii).contiguous())
        bad += int((got.view(torch.int32) != cutout_xi(kk, ii).view(torch.int32)).sum())
    log(f"cutout draws {label}: {bad} of {2 * key.numel() * ids.numel()} not bit-equal")
    assert bad == 0, label


def phase_branches(device, replay: dict, exact: bool = False):
    """Phase 3e (and 3f, with `exact`: rows 12-15, H_HIT and H_MAT
    bit-equal on every ray): each branch's kernel against its twin on the
    recorded waves (bounces 0 and 2) and the tables gi built; each timed at
    bounce 0 with CUDA events. Returns {case: numbers}."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.bounce_ref import P_TMIN, cutout_key, walk_closest, \
        walk_hit_attrs, walk_work
    from gatling_tpu_torch.ops.split_ref import H_T, trace_ref
    from gatling_tpu_torch.ops.split_ref import material_rows

    out = {}
    for label, (fs, static, waves, nee) in replay.items():
        errs, k3_errs = [], []
        if fs.cutout:
            check_draws(label, waves[0][1], fs)
        for b, (p, state, split) in sorted(waves.items()):
            if split is None:
                twin = state.clone()
                bounce_twin(p, fs, twin, nee)
                got = state.clone()
                tb.bounce_step(p, fs, got, nee)
                torch.cuda.synchronize()
                check_parity(f"{label} bounce {b}", got, twin, errs, exact)
                r_in = int((state[13] > 1.5).sum())
                log(f"  {label} bounce {b}: {r_in} rays came in inside a medium")
                continue
            hitbuf, mats, pool = split
            active = static.textured_params
            hit = trace_ref(p, fs.tris, state, fs.walk, fs.cutout)
            got_hit = tb.trace_step(p, fs, state)
            twin = state.clone()
            split_twin(p, fs, twin, hitbuf, mats, pool, active, nee)
            got = state.clone()
            tb.shade_step(p, fs, got, hitbuf, mats, pool, active, nee)
            torch.cuda.synchronize()
            hb, ho, n, herr = compare_hits(got_hit, hit)
            log(f"parity {label} bounce {b} K3: {hb} rays with H_HIT/H_MAT not bit-equal, {ho} "
                f"of {n} outside rtol {RTOL}/atol {ATOL}, max abs err {herr:.3g} (hit rays)")
            assert hb <= (0 if exact else n * (1 - MIN_AGREE)), (label, b, hb)
            assert ho <= n * (1 - MIN_AGREE), (label, b, ho)
            k3_errs.append(herr)
            # K4 against its twin: rows 12-15 on every ray, as in 3c
            check_parity(f"{label} bounce {b} K4", got, twin, errs, exact=True)

        # bounce 0 timed: the kernel(s), the twin(s), the bound
        p, wave, split = waves[0]
        alive = wave[13] > 0.5
        r = dict(rays=wave.shape[1], alive=int(alive.sum()), err=max(errs),
                 k3_err=max(k3_errs) if k3_errs else None)
        if split is None:
            r["ms"] = time_ms(lambda s: tb.bounce_step(p, fs, s, nee), wave)
            r["plain_ms"] = time_ms(lambda s: bounce_twin(p, fs, s, nee), wave, reps=1)
            if fs.walk is None:
                r["bound"], r["work"] = k1_walk_bound_ms(p, fs, wave, nee)
                r["bound_brute"] = k1_bound_ms(wave, fs)
            else:
                o, d = wave[0:3].T.contiguous(), wave[3:6].T.contiguous()
                tmin = float(p[P_TMIN])
                key = cutout_key(wave) if fs.cutout else None
                win = walk_closest(fs.walk, fs.tris, o, d, alive, tmin, key)
                t_hit = walk_hit_attrs(fs.walk, fs.tris, o, d, win)[0]
                r["floor"] = walk_work(fs.walk, o, d, alive, tmin, t_hit)
                r["work"] = cluster_walk_work(p, fs, wave, nee)
                r["bound"] = k2_bound_ms(wave, fs, walk_ops(r["work"]))
                r["floor_bound"] = k2_bound_ms(wave, fs, floor_ops(r["floor"]))
        else:
            hitbuf, mats, pool = split
            active = static.textured_params
            hit = tb.trace_step(p, fs, wave)
            o, d = wave[0:3].T.contiguous(), wave[3:6].T.contiguous()
            r["work"] = (cluster_walk_work(p, fs, wave, False)
                         if fs.walk is not None else resident_walk_work(p, fs, wave, False))
            r["k3_ms"] = time_ms(lambda s: tb.trace_step(p, fs, s), wave)
            r["k3_plain_ms"] = time_ms(lambda s: trace_ref(p, fs.tris, s, fs.walk, fs.cutout),
                                       wave, reps=1)
            r["k3_bound"] = k3_bound_ms(wave, fs, hit.shape[0], r["work"])
            if fs.walk is not None:
                r["floor"] = walk_work(fs.walk, o, d, alive, float(p[P_TMIN]), hit[H_T])
                r["k3_floor_bound"] = k3_bound_ms(wave, fs, hit.shape[0], r["floor"], floor=True)
            r["ms"] = time_ms(lambda s: tb.shade_step(p, fs, s, hitbuf, mats, pool, active, nee),
                              wave)
            r["plain_ms"] = time_ms(lambda s: split_twin(p, fs, s, hitbuf, mats, pool, active,
                                                         nee), wave, reps=1)
            r["stage_ms"] = time_ms(lambda h: material_rows(mats, pool, h, active), hitbuf)
            r["bound"], r["k4_work"], r["k4_texels"] = k4_bound_ms(p, fs, wave, hitbuf, mats, pool,
                                                                   active, nee)
            r["k4_floor"] = k4_floor_ms(wave, fs, 3 * len(active))
        out[label] = r
        log(f"timing {label} bounce 0 ({r['rays']} rays, {r['alive']} alive): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()
            if k not in ("rays", "alive")))
    return out


def device_ms(fn, launches: int = 200) -> float:
    """The device time of one launch of fn(): CUDA events around `launches`
    back-to-back calls after a warm-up, over `launches`. The calls are
    queued behind a device sleep that outlasts their enqueue (asserted), so
    the events time the device running them back to back, not the host
    issuing them."""
    import torch

    for _ in range(3):
        fn()
    cycles = 20_000_000
    for _ in range(4):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if enqueue_ms < 0.8 * ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / launches
        cycles *= 4
    raise AssertionError("device_ms: the enqueue outlasted the device sleep")


def enqueue_us(fn, calls: int = 1000) -> float:
    """The host's time to issue one call of fn(): a host clock around
    `calls` calls, then one synchronize (outside the clock)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def launch_times(fn, launches: int = 200) -> dict:
    """A call's device time (device_ms over `launches` calls: their kernel
    launches must fit the device's queue of pending launches, about a
    thousand, or the enqueue waits for the device), its time as one call
    with the host's enqueue (event_ms) and the enqueue alone (enqueue_us)."""
    return dict(ms=device_ms(fn, launches), ms_one_call_with_enqueue=event_ms(fn),
                enqueue_us=enqueue_us(fn))


def phase_probes(device):
    """Phase P: the probes P1 and P2 through their entry points (launches
    counted over that run), held against their twins; each timed with CUDA
    events beside its twin and the library call, P2 and torch.matmul also
    as the device time a launch and the host's enqueue. Returns their
    numbers: launches, P1's, P2's by mode, torch.matmul's by allow_tf32
    and the host's cost of a stream handle."""
    import torch

    from gatling_tpu_torch import tools
    from gatling_tpu_torch.ops.cuda_lib import CudaLibrary
    from gatling_tpu_torch.tools import cast_probe, precision_probe

    for k in tools.launches:
        tools.launches[k] = 0
    cast = cast_probe.run(device)
    prec = precision_probe.run(device)
    launches = dict(tools.launches)
    log(f"probes: launches {launches}")
    assert all(ok for ok, _deg in cast.values()), cast
    assert prec["DEFAULT (TF32)"][2] and prec["HIGHEST (FP32)"][2] and prec["3xTF32"][2], prec

    # launches below compare and time; they do not count
    x = cast_probe.probe_input(device)
    moves = range(len(cast_probe.MOVES))
    one = torch.zeros(1, device=device)
    p1 = dict(
        # the one launch's device time (as P2's), and the whole run's: the
        # six outputs' allocations and the launch, with the host's enqueue
        ms=device_ms(lambda: cast_probe.cast_moves(x)),
        run_ms=event_ms(lambda: cast_probe.cast_moves(x)),
        plain_ms=event_ms(lambda: [cast_probe.cast_twin(x, m) for m in moves]),
        # bytes: the tile read once and each move's output written once
        bound=_bound(4 * (x.numel() + sum(math.prod(shape) for _n, shape in cast_probe.MOVES)),
                     0),
        # the least a launch takes back to back: a one-element add_
        launch_floor_ms=device_ms(lambda: one.add_(1.0)),
        err=max(float((got - cast_probe.cast_twin(x, m)).abs().max())
                for m, got in enumerate(cast_probe.cast_moves(x))),
        conflicts={n: deg for n, (_ok, deg) in cast.items()})
    p1["library_ms"] = p1["plain_ms"]  # the twin is the torch calls themselves
    oh, xm = precision_probe.probe_inputs(device)
    n = precision_probe.N
    flops = 2 * n ** 3
    nbytes = 3 * 4 * n * n
    p2 = {}
    for name, mode in precision_probe.MODES:
        peak = F32_FLOPS if mode == 1 else TF32_FLOPS
        t_ops = (3 if mode == 2 else 1) * flops / peak
        got = precision_probe.onehot_product(oh, xm, mode)
        p2[name] = dict(
            **launch_times(lambda m=mode: precision_probe.onehot_product(oh, xm, m)),
            plain_ms=event_ms(lambda m=mode: precision_probe.product_twin(oh, xm, m)),
            bound=(max(nbytes / HBM_BPS, t_ops) * 1e3,
                   "bytes" if nbytes / HBM_BPS >= t_ops else "operations"),
            err=float((got - precision_probe.product_twin(oh, xm, mode)).abs().max()),
            err_vs_x=prec[name][0])
    # the host's cost of the stream handle a wrapper passes its kernel:
    # PyTorch's Stream object, and the raw getter ops/cuda_lib.py calls
    stream_us = {
        "torch.cuda.current_stream(device).cuda_stream":
            enqueue_us(lambda: torch.cuda.current_stream(device).cuda_stream),
        "CudaLibrary.stream": enqueue_us(lambda: CudaLibrary.stream(oh))}
    library = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = allow
            library[allow] = launch_times(lambda: torch.matmul(oh, xm))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log(f"timing P1 (six moves) {p1}; P2 {p2}; torch.matmul by allow_tf32 {library}; "
        f"stream handle us {stream_us}")
    return launches, p1, p2, library, stream_us


BRANCHES = (  # kernels-line entries of the branches: (name, 3e case, replaces)
    ("bounce_step (K1, advanced lobes)", "glass_coated",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step -> _bounce_kernel :2162, advanced "
     "branch of _shade_core :2381 (:2453-2762) and _resolve_material_rows :2190"),
    ("bounce_step (K1, cutout)", "cornell_cutout",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step -> _bounce_kernel :2162, cutout "
     "branch: _cutout_xi :1445, _cutout_xi8 :1459, resident searches :2874-2900"),
    ("bounce_step_walk (K2, advanced lobes + cutout)", "sphere_field_lobes",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step, clustered+instanced branch: "
     "_trace_clustered_matrix :1513 (cutout :1570, :1657-1668), _trace_clustered_occluded "
     ":2002 (:2058, :2127-2138), advanced _shade_core :2381"),
    ("trace_step (K3, cutout)", "interior_lobes",
     "gatling_tpu/ops/pallas_bounce.py:3663 trace_step -> _trace_kernel :3241, cutout "
     ":3276-3311"),
    ("shade_step (K4, advanced lobes)", "interior_lobes",
     "gatling_tpu/ops/pallas_bounce.py:3705 shade_step -> _shade_kernel :3370, advanced "
     "_shade_core :2381 in the mesh-tangent frame (:2453-2473)"),
)
VOLUME_BRANCHES = (  # kernels-line entries of the volume branches: (name, 3f case, replaces)
    ("bounce_step (K1, volumes: absorption)", "glass_tinted",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step -> _bounce_kernel :2162, volumes "
     "branch of _shade_core :2381 (:2414-2430) and the medium toggle (:2930-2940)"),
    ("bounce_step (K1, scatter)", "cornell_fog",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step -> _bounce_body :2240, scatter "
     "branch: _resolve_medium_rows :2223, free flight :2255-2290, segment cap :2321-2330, "
     "transmittance :2404-2413, walk step :2779-2831, encoding :2941-2954"),
    ("bounce_step_walk (K2, volumes + scatter)", "sphere_field_volumes",
     "gatling_tpu/ops/pallas_bounce.py:3192 bounce_step, clustered+instanced branch "
     "(_trace_clustered_matrix :1513, _trace_clustered_occluded :2002) with the volumes "
     "and scatter branches of _bounce_body / _shade_core"),
    ("shade_step (K4, volumes: absorption)", "interior_tinted",
     "gatling_tpu/ops/pallas_bounce.py:3705 shade_step -> _shade_kernel :3370 (:3407), "
     "volumes branch of _shade_core :2381 (:2414-2430, :2930-2940)"),
)


def branch_entries(branch: dict, lobe_launches: dict, table=BRANCHES) -> list[dict]:
    """The kernels-line entries of the branches from 3e's (3f's) numbers
    (bounce 0 of the case's first recorded wave); launches per frame of 4f
    (4g)."""
    out = []
    for name, case, replaces in table:
        r = branch[case]
        k3 = name.startswith("trace_step")
        n = lobe_launches[case]
        if isinstance(n, dict):
            n = n["K3" if k3 else "K4"]
        ms, plain, bound = (("k3_ms", "k3_plain_ms", "k3_bound") if k3
                            else ("ms", "plain_ms", "bound"))
        entry = {"name": name, "route": "cuda", "source": "gatling_tpu_torch/csrc/bounce.cu",
                 "replaces": replaces, "launches": n,
                 "max_abs_err": max(v["k3_err" if k3 else "err"] for k, v in branch.items()
                                    if k.startswith(case)),
                 "ms": r[ms], "plain_ms": r[plain], "bound_ms": r[bound][0],
                 "bound_by": r[bound][1], "library_ms": None, "rays": r["rays"],
                 "alive": r["alive"]}
        if not k3 and "bound_brute" in r:  # a resident K1: the BVH walk's bound, brute force's
            entry["bound_ms_brute_force"] = r["bound_brute"][0]
        if "k4_floor" in r:  # K4: the texture stage its taps replace, PR 3-9's floor
            entry.update(texture_stage_ms=r["stage_ms"], bound_ms_pr3_9_floor=r["k4_floor"][0],
                         shadow_walk_work=r["k4_work"], distinct_texel_rows=r["k4_texels"])
        floor = "k3_floor_bound" if k3 else "floor_bound"
        if floor in r:  # a walk: its counted bound, the brute-force cluster floor
            entry["bound_ms_cluster_floor"] = r[floor][0]
            entry["walk_work"] = r["work"]
        others = {k: v for k, v in branch.items() if k.startswith(case) and k != case}
        if others:
            entry["ms_by_case"] = {k: v[ms] for k, v in others.items()}
            entry["plain_ms_by_case"] = {k: v[plain] for k, v in others.items()}
            entry["bound_ms_by_case"] = {k: v[bound][0] for k, v in others.items()}
            if "bound_ms_brute_force" in entry:
                entry["bound_ms_brute_force_by_case"] = {k: v["bound_brute"][0]
                                                         for k, v in others.items()}
        out.append(entry)
    return out


def probe_entries(launches: dict, p1: dict, p2: dict, library: dict,
                  stream_us: dict) -> list[dict]:
    """The kernels-line entries of P1 (the six moves together) and P2 (the
    TF32 product; FP32 and 3xTF32 beside it). P2's ms and library_ms are
    device times a launch; the one-call times with the host's enqueue and
    the enqueue alone stand beside them."""
    tf32 = p2["DEFAULT (TF32)"]
    return [{
        "name": "cast_probe (P1, six layout moves of an (8, 128) f32 tile, one launch, a "
                "block a move)",
        "route": "cuda", "source": "gatling_tpu_torch/csrc/probes.cu",
        "replaces": "tools/mosaic_cast_probe.py:8 probe", "launches": launches["P1"],
        "max_abs_err": p1["err"], "ms": p1["ms"], "plain_ms": p1["plain_ms"],
        "bound_ms": p1["bound"][0], "bound_by": p1["bound"][1], "library_ms": p1["library_ms"],
        "bank_conflicts": p1["conflicts"], "run_ms": p1["run_ms"],
        "launch_floor_ms": p1["launch_floor_ms"],
    }, {
        "name": "onehot_product (P2, one-hot 128x128 product, TF32 mma.sync from staged "
                "shared memory)",
        "route": "cuda", "source": "gatling_tpu_torch/csrc/probes.cu",
        "replaces": "tools/mosaic_precision_probe.py:8 kern", "launches": launches["P2"],
        "max_abs_err": max(v["err"] for v in p2.values()),
        "ms": tf32["ms"], "plain_ms": tf32["plain_ms"], "bound_ms": tf32["bound"][0],
        "bound_by": tf32["bound"][1], "library_ms": library[True]["ms"],
        "ms_one_call_with_enqueue": tf32["ms_one_call_with_enqueue"],
        "enqueue_us": tf32["enqueue_us"],
        "library_ms_one_call_with_enqueue": library[True]["ms_one_call_with_enqueue"],
        "library_enqueue_us": library[True]["enqueue_us"],
        "library_ms_fp32": library[False]["ms"],
        "library_ms_fp32_one_call_with_enqueue": library[False]["ms_one_call_with_enqueue"],
        "stream_handle_us": stream_us,
        "by_mode": {k: dict(ms=v["ms"], ms_one_call_with_enqueue=v["ms_one_call_with_enqueue"],
                            enqueue_us=v["enqueue_us"], plain_ms=v["plain_ms"],
                            bound_ms=v["bound"][0], bound_by=v["bound"][1],
                            err_vs_x=v["err_vs_x"])
                    for k, v in p2.items()},
    }]


# ---------------------------------------------------------------------------
# 4h, 4i, 4j, 3g and the goldens: the fused route's bounce-0 peel (first-hit
# AOVs, camera clipping), the textured cutout's re-trace, K4's taps alone,
# and the committed graphical scenes through the port's harness
# ---------------------------------------------------------------------------

FIRST_HIT = ("COLOR", "NORMAL", "ALBEDO", "DEPTH", "TEXCOORDS")
# 4h: the fused first-hit AOVs against the wavefront's of the same samples.
# Both trace the same primary rays (the same PCG streams); the fused search
# (Baldwin-Weber) and the wavefront's (Moller-Trumbore) round t, u and v
# differently in the last bits, and an edge ray can meet the other triangle.
# A silhouette pixel whose samples hit and miss differs too: the fused
# frame keeps the last hit sample's DEPTH and TEXCOORDS
# (gatling_tpu/render/fused.py:520-523), the wavefront the last sample's
# (gatling_tpu/render/integrator.py render_pixels)
FH_RTOL, FH_ATOL, FH_AGREE = 1e-3, 1e-4, 0.99
# 4i, 4j: a fused frame's mean against the wavefront frame's of the same
# samples, within MEAN_SIGMAS standard errors of the mean of their
# per-pixel differences: the two shade in different frames (Duff's and the
# mesh tangents'), so their paths part after the first bounce and the
# pixels' differences are noise of that size
MEAN_SIGMAS = 5.0
# 4i: the ranges of tests/test_fused.py:850 (open: the camera's own)
CLIP_RANGES = {"open": None, "near": (6.5, 1000.0), "far": (0.1, 7.0)}
# 4j: the checker's share of transparent texels, and the first wave's pass
# rate's tolerance
CUTOUT_PASS, CUTOUT_PASS_TOL = 0.5, 0.01
# 4j: the fused-against-wavefront pairs, (maxBounces, TEX_CUTOUT_ROUNDS).
# The wavefront spends a bounce on each pass through a cutout
# (gatling_tpu/render/integrator.py:529-538: the loop's next segment), the
# fused re-trace none, so at the bench's 6 bounces the wavefront's paths
# end earlier and its frame is darker: those pairs are logged, not held.
# The 6-bounce pair at 16 rounds tells that gap from the re-trace's round
# cap (a ray rejected by every round keeps its last hit): a cap at fault
# would close the gap there. From CUTOUT_MEAN_BOUNCES paths end by roulette
# before either budget, and the pairs are held to MEAN_SIGMAS
CUTOUT_MEAN_BOUNCES = 24
CUTOUT_MEAN_PAIRS = ((SF_BOUNCES, 4), (SF_BOUNCES, 16), (CUTOUT_MEAN_BOUNCES, 4), (48, 4))
ALBEDO_MAX = 2.0  # bsdf.auxiliary: diffuse albedo + Schlick Fresnel (1 at grazing)


def fh_params(device, desc, res: int, settings: dict, wavefront: bool = False, lights=()):
    """gi render parameters binding the fused first-hit AOVs (and with
    `wavefront` OBJECT_ID too, which sends the frame to the wavefront)."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId

    params = desc_params(device, desc, res, settings)
    for light in lights:
        params.scene.add_light(light)
    aovs = [AovId[a] for a in FIRST_HIT[1:]]
    params.aov_bindings += [gi.GiAovBinding(a, gi.GiRenderBuffer(res, res, 4)) for a in aovs]
    if wavefront:
        params.aov_bindings.append(gi.GiAovBinding(
            AovId.OBJECT_ID, gi.GiRenderBuffer(res, res, 1, True), clear_value=-1))
    return params


def aov_buffers(params) -> dict:
    return {b.aov_id.name: b.render_buffer.data.copy() for b in params.aov_bindings}


def hit_pixels(bufs):
    """Pixels some sample hit: the NORMAL buffer holds (n + 1) / 2 of a
    unit normal there, 0.5 (the zero vector) where every sample missed."""
    import numpy as np

    n = bufs["NORMAL"][..., :3] * 2.0 - 1.0
    return np.linalg.norm(n, axis=-1) > 0.5, n


def check_first_hit(bufs, label, albedo_max: float = ALBEDO_MAX):
    """4h's checks of a fused first-hit frame: COLOR finite and
    non-negative; unit normals where hit; ALBEDO in [0, albedo_max];
    DEPTH and TEXCOORDS finite. Returns the share of hit pixels."""
    import numpy as np

    color = bufs["COLOR"][..., :3]
    assert np.isfinite(color).all() and (color >= 0).all() and color.mean() > 0.01, label
    hit, n = hit_pixels(bufs)
    albedo = bufs["ALBEDO"][..., :3]
    assert hit.mean() > 0.3, (label, hit.mean())
    assert np.abs(np.linalg.norm(n[hit], axis=-1) - 1.0).max() < 1e-3, label
    assert np.isfinite(albedo).all() and albedo.min() >= 0 and albedo.max() <= albedo_max, label
    assert np.isfinite(bufs["DEPTH"]).all() and np.isfinite(bufs["TEXCOORDS"]).all(), label
    log(f"{label}: {hit.mean():.4f} of pixels hit; albedo {albedo.min():.4f}-{albedo.max():.4f}"
        f", depth {bufs['DEPTH'][..., 0][hit].min():.4f}-{bufs['DEPTH'][..., 0][hit].max():.4f}")
    return float(hit.mean())


def compare_first_hit(fused, wave, label) -> dict:
    """NORMAL, DEPTH and TEXCOORDS of a fused first-hit frame against the
    wavefront's of the same samples: the share of the pixels both hit
    within FH_RTOL / FH_ATOL, each at least FH_AGREE; and the share of
    pixels whose hit flags agree (logged: the fused flag is any sample's,
    the wavefront's the last sample's)."""
    import numpy as np

    hf, _n = hit_pixels(fused)
    hw, _n = hit_pixels(wave)
    both = hf & hw
    out = {"hit_agree": float((hf == hw).mean())}
    for aov, ch in (("NORMAL", 3), ("DEPTH", 1), ("TEXCOORDS", 2)):
        f, w = fused[aov][..., :ch][both], wave[aov][..., :ch][both]
        out[aov] = float(np.isclose(f, w, rtol=FH_RTOL, atol=FH_ATOL).all(-1).mean())
    log(f"{label}: fused first-hit AOVs against the wavefront's, the same samples: {out} "
        f"within rtol {FH_RTOL} / atol {FH_ATOL} on {int(both.sum())} pixels both hit")
    assert all(out[a] >= FH_AGREE for a in ("NORMAL", "DEPTH", "TEXCOORDS")), out
    return out


def mean_gap(fused, wave, label, held: bool = True) -> dict:
    """The two COLOR frames' means and their gap in standard errors of the
    mean of the per-pixel differences; at most MEAN_SIGMAS if `held`."""
    import numpy as np

    f, w = fused[..., :3].astype(np.float64), wave[..., :3].astype(np.float64)
    diff = (f - w).mean(-1).ravel()
    se = diff.std() / math.sqrt(diff.size)
    gap = f.mean() - w.mean()
    out = dict(fused=float(f.mean()), wavefront=float(w.mean()), se=float(se),
               sigmas=float(abs(gap) / max(se, 1e-30)))
    log(f"{label}: COLOR mean fused {out['fused']:.6f}, wavefront {out['wavefront']:.6f}, gap "
        f"{gap:.3g} = {out['sigmas']:.2f} standard errors ({se:.3g}; "
        f"{f'tolerance {MEAN_SIGMAS}' if held else 'not held'})")
    assert np.isfinite(f).all() and (out["sigmas"] <= MEAN_SIGMAS or not held), (label, out)
    return out


class KernelCalls:
    """Keeps copies of the inputs of the first `limit` calls render/fused.py
    makes of its kernel entry points `names` (by default trace_step,
    tap_rows and shade_step: K3, K4t, K4; or its dome_pass) inside the
    `with` block: [(name, args)] in call order."""

    def __init__(self, limit: int, names=("trace_step", "tap_rows", "shade_step")) -> None:
        self.limit, self.calls, self.names = limit, [], names

    def __enter__(self):
        import torch

        from gatling_tpu_torch.render import fused

        self.real = {k: getattr(fused, k) for k in self.names}

        def wrap(name):
            def call(*args):
                if len(self.calls) < self.limit:
                    self.calls.append((name, [a.clone() if isinstance(a, torch.Tensor) else a
                                              for a in args]))
                return self.real[name](*args)
            return call

        for k in self.names:
            setattr(fused, k, wrap(k))
        return self

    def __exit__(self, *exc) -> None:
        from gatling_tpu_torch.render import fused

        for k, f in self.real.items():
            setattr(fused, k, f)

    def of(self, name: str) -> list:
        return [args for n, args in self.calls if n == name]


def frame_pair(params, label, want: set, record: int = 0):
    """A first frame and a warm one (first_and_warm), the first `record`
    kernel calls recorded (KernelCalls: the first frame's; the warm frame
    traces the same samples on the same tables); the texture stage must
    not run. Returns (buffers, times, launches, KernelCalls)."""
    from gatling_tpu_torch.ops import split_ref

    with KernelCalls(record) as calls:
        _img, times, launches = first_and_warm(params, label, want)
    assert split_ref.stage_calls == 0, (label, split_ref.stage_calls)
    return aov_buffers(params), times, launches, calls


def phase_first_hit(device, tex_dir: str):
    """Phase 4h: the first-hit AOVs on the fused route (COLOR, NORMAL,
    ALBEDO, DEPTH and TEXCOORDS bound): the Cornell box with the bench's
    rect light (1200x1200, 16 spp, 8 bounces, NEE: K3, K4's taps, K4 at
    bounce 0 of each sample, K1 after) and the textured interior (512x512,
    4 spp, 6 bounces, NEE: K3/K4 every bounce), a first and a warm frame
    each with their launches; then interior(detail=1) and the Cornell box
    held against the wavefront's first-hit AOVs of the same samples.
    Returns (frames, launches by frame, recorded tap_rows waves)."""
    from gatling_tpu_torch.scene.examples import interior
    from gatling_tpu_torch.scene.stage import load_scene

    cornell = load_scene(CORNELL)
    settings = merged_settings(cornell, spp=AOVS_SPP, maxBounces=AOVS_BOUNCES,
                               nextEventEstimation=True)
    frames, launches, waves = {}, {}, []
    params = fh_params(device, cornell, AOVS_RES, settings, lights=(bench_rect_light(),))
    bufs, frames["cornell_first_hit"], launches["cornell_first_hit"], calls = frame_pair(
        params, f"cornell_first_hit {AOVS_RES}^2 {AOVS_SPP}spp {AOVS_BOUNCES} bounces nee",
        {"K1", "K3", "K4", "K4t"}, record=3)
    n = launches["cornell_first_hit"]
    # one sample a wave: K3, the taps and K4 peel bounce 0 of each, K1 after
    assert n["K3"] == n["K4"] == n["K4t"] == AOVS_SPP and n["K1"] > n["K3"], n
    frames["cornell_first_hit"]["hit_share"] = check_first_hit(bufs, "cornell_first_hit")
    waves.append(("cornell_first_hit", calls.of("tap_rows")[0]))
    fused_cornell = bufs

    desc = interior(tex_dir=tex_dir)
    settings = merged_settings(desc, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True)
    params = fh_params(device, desc, SF_RES, settings)
    bufs, frames["interior_first_hit"], launches["interior_first_hit"], calls = frame_pair(
        params, f"interior_first_hit {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee",
        {"K3", "K4", "K4t"}, record=4)
    n = launches["interior_first_hit"]
    assert n["K4t"] == SF_SPP and n["K3"] == n["K4"] > SF_SPP, n
    frames["interior_first_hit"]["hit_share"] = check_first_hit(bufs, "interior_first_hit")
    waves.append(("interior_first_hit", calls.of("tap_rows")[0]))

    # the wavefront's first-hit AOVs of the same samples
    small = interior(detail=1, tex_dir=tex_dir)
    s = merged_settings(small, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True)
    out = {}
    for route in ("fused", "wavefront"):
        params = fh_params(device, small, SF_RES, s, wavefront=route == "wavefront")
        counted_render(params, f"interior_first_hit detail=1, {route}")
        assert (params.scene._fused is None) == (route == "wavefront"), route
        out[route] = aov_buffers(params)
    frames["interior_first_hit_vs_wavefront"] = compare_first_hit(
        out["fused"], out["wavefront"], "interior_first_hit detail=1")
    params = fh_params(device, cornell, AOVS_RES, merged_settings(
        cornell, spp=AOVS_SPP, maxBounces=AOVS_BOUNCES, nextEventEstimation=True),
        wavefront=True, lights=(bench_rect_light(),))
    counted_render(params, "cornell_first_hit, wavefront")
    frames["cornell_first_hit_vs_wavefront"] = compare_first_hit(
        fused_cornell, aov_buffers(params), "cornell_first_hit")
    return frames, launches, waves


def clip_params(device, desc, clip, wavefront: bool):
    """The Cornell box at the bench's plain settings (1200x1200, 16 spp, 8
    bounces) with clippingPlanes on, the camera's range `clip` (None: its
    own); with `wavefront`, an OBJECT_ID binding beside COLOR."""
    import copy

    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId

    params = desc_params(device, desc, FULL_RES, merged_settings(
        desc, spp=LOBES_SPP, maxBounces=LOBES_BOUNCES, clippingPlanes=True))
    if clip is not None:
        params.camera = copy.deepcopy(params.camera)
        params.camera.clip_start, params.camera.clip_end = clip
    if wavefront:
        params.aov_bindings.append(gi.GiAovBinding(
            AovId.OBJECT_ID, gi.GiRenderBuffer(FULL_RES, FULL_RES, 1, True), clear_value=-1))
    return params


def phase_clipping(device):
    """Phase 4i: camera clipping planes on the fused route, the Cornell box
    at 1200x1200, 16 spp, 8 bounces: the open range (the camera's own), a
    near plane that cuts the room and a far plane that cuts it, a first and
    a warm frame each (K3 and K4 peel bounce 0 of each wave, K1 after);
    the near and far frames against the wavefront's of the same samples
    (mean_gap), and the cuts changing the image as tests/test_fused.py:850
    asserts. Returns (frames, launches, recorded peel waves)."""
    from gatling_tpu_torch.render.fused import spp_batch_size
    from gatling_tpu_torch.scene.stage import load_scene

    desc = load_scene(CORNELL)
    frames, launches, waves, means = {}, {}, {}, {}
    for name, clip in CLIP_RANGES.items():
        params = clip_params(device, desc, clip, False)
        bufs, frames[name], launches[name], calls = frame_pair(
            params, f"cornell_clip_{name} {FULL_RES}^2 {LOBES_SPP}spp {LOBES_BOUNCES} bounces",
            {"K1", "K3", "K4"}, record=2)
        n = launches[name]
        # the clip-only peel keeps the spp batching: one K3 and K4 a wave
        n_waves = LOBES_SPP // spp_batch_size(FULL_RES * FULL_RES, LOBES_SPP)
        assert n["K3"] == n["K4"] == n_waves and n["K4t"] == 0, n
        means[name] = float(bufs["COLOR"][..., :3].mean())
        if clip is None:
            continue
        (_t, trace), = [c for c in calls.calls if c[0] == "trace_step"][:1]
        (_s, shade), = [c for c in calls.calls if c[0] == "shade_step"][:1]
        waves[name] = (trace, shade)
        wave = clip_params(device, desc, clip, True)
        counted_render(wave, f"cornell_clip_{name}, wavefront")
        assert wave.scene._fused is None
        frames[name]["vs_wavefront"] = mean_gap(bufs["COLOR"], aov_buffers(wave)["COLOR"],
                                                f"cornell_clip_{name}")
    log(f"clipping: COLOR means {means}")
    assert abs(means["near"] - means["open"]) > 0.005, means
    assert means["far"] < 0.6 * means["open"], means
    return frames, launches, waves


def checker_mask(path: str, size: int = 64, square: int = 4) -> str:
    """A checker of alpha 0 and 255 in squares of `square` texels (white
    RGB), written with the port's PNG writer."""
    import numpy as np

    from gatling_tpu_torch import imgio

    c = (np.arange(size)[:, None] // square + np.arange(size)[None, :] // square) % 2
    img = np.full((size, size, 4), 255, np.uint8)
    img[..., 3] = np.where(c, 255, 0)
    imgio.write_image_file(path, img)
    return path


def cutout_interior(tex_dir: str, detail: int = 5):
    """The interior with its instanced bowls' opacity the checker mask's
    alpha at opacityThreshold 0.5 (a leaf- or fence-like cutout). The
    bowls also emit (1, 1, 1): the interior's lights reach the camera only
    through NEE, so without NEE the frame is lit by the bowls alone, and
    what it shows depends on the mask."""
    from gatling_tpu_torch.scene.examples import interior
    from gatling_tpu_torch.scene.stage import ShaderNode

    desc = interior(detail=detail, tex_dir=tex_dir)
    bowl = surface_variant(desc.materials["/m_bowl"], opacityThreshold=0.5,
                           emissiveColor=(1.0, 1.0, 1.0))
    node = ShaderNode(path="/m_bowl/mask", shader_id="UsdUVTexture",
                      inputs={"file": checker_mask(os.path.join(tex_dir, "mask.png")),
                              "sourceColorSpace": "raw"}, input_connections={})
    bowl.nodes[node.path] = node
    bowl.nodes[bowl.surface_node].input_connections["opacity"] = (node.path, "a")
    desc.materials["/m_bowl"] = bowl
    return desc


def first_wave_pass_rate(calls, bowl: int):
    """On the first wave of a frame recorded by KernelCalls (its first K3
    state and the first round's taps of that hit buffer): the share of
    the alive rays whose hit is a bowl (material `bowl`) that the
    re-trace's first draw lets through the mask, their count, and the mean
    of their pass probabilities."""
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.sampling import f32_bits_to_u32
    from gatling_tpu_torch.ops.split_ref import H_HIT
    from gatling_tpu_torch.render import bsdf
    from gatling_tpu_torch.render.fused import _hit_materials, _tapped_params, retrace_draws

    _p, _fs, state = calls.of("trace_step")[0]
    hit, mats, pool, active = calls.of("tap_rows")[0]
    mat = _hit_materials(hit, mats)
    pass_prob = bsdf.cutout_opacity(_tapped_params(mats, mat, tb.tap_rows(hit, mats, pool,
                                                                          active)))
    on = (state[13] > 0.5) & (hit[H_HIT] > 0.5) & (mat == bowl)
    passed = on & (retrace_draws(f32_bits_to_u32(state[12]), 0) >= pass_prob)
    n = int(on.sum())
    return float(passed.sum()) / max(n, 1), n, float((1.0 - pass_prob)[on].mean())


def phase_textured_cutout(device, tex_dir: str):
    """Phase 4j: the textured cutout on the fused route: cutout_interior
    (the bowls' opacity a checker mask) at the bench's 512x512, 4 spp, 6
    bounces, NEE off and on, a first and a warm frame each: every split
    bounce K3, then three re-trace rounds (K4's taps of the opacity, K3 on
    the rejected rays), then K4; the NEE shadow walk draws against the
    mask's mean pass rate (gi.shadow_cutout_pass). The first wave's pass
    rate through the mask, and interior(detail=1)'s NEE-off frame against
    the wavefront's (which taps the opacity at every hit) of the same
    samples, held at 24 and 48 bounces and logged at 6 (CUTOUT_MEAN_PAIRS).
    Returns (frames, launches, KernelCalls of the NEE-off frame)."""
    import numpy as np

    desc = cutout_interior(tex_dir)
    frames, launches, recorded = {}, {}, None
    for nee in (False, True):
        label = f"interior_cutout nee={nee}"
        params = desc_params(device, desc, SF_RES, merged_settings(
            desc, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=nee))
        bufs, frames[label], launches[label], calls = frame_pair(
            params, f"{label} {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces",
            {"K3", "K4", "K4t"}, record=8)
        scene = params.scene
        st = scene._fused_static
        assert st.instanced and st.textured and st.cutout_textured and scene._fused.cutout, st
        n = launches[label]
        # a split bounce: one K3, TEX_CUTOUT_ROUNDS - 1 rounds of taps and K3, one K4
        assert n["K3"] == 4 * n["K4"] and n["K4t"] == 3 * n["K4"] and n["K3"] > SF_BOUNCES, n
        img = bufs["COLOR"][..., :3]
        assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0.01, label
        if not nee:
            rate, hits, mean_pass = first_wave_pass_rate(calls, scene._material_index["/m_bowl"])
            log(f"{label} first wave: {hits} rays hit a bowl first, {rate:.5f} of them pass the "
                f"mask (mean pass probability {mean_pass:.5f}; want {CUTOUT_PASS} +- "
                f"{CUTOUT_PASS_TOL})")
            assert hits > 1000 and abs(rate - CUTOUT_PASS) <= CUTOUT_PASS_TOL, (rate, hits)
            frames[label].update(pass_rate=rate, bowl_hits=hits, mean_pass_probability=mean_pass)
            recorded = calls
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.interface import AovId

    from gatling_tpu_torch.render import fused

    small = cutout_interior(tex_dir, detail=1)
    for bounces, rounds in CUTOUT_MEAN_PAIRS:
        out = {}
        for route in ("fused", "wavefront"):
            params = desc_params(device, small, SF_RES, merged_settings(
                small, spp=SF_SPP, maxBounces=bounces, nextEventEstimation=False))
            if route == "wavefront":
                params.aov_bindings.append(gi.GiAovBinding(
                    AovId.OBJECT_ID, gi.GiRenderBuffer(SF_RES, SF_RES, 1, True), clear_value=-1))
            saved, fused.TEX_CUTOUT_ROUNDS = fused.TEX_CUTOUT_ROUNDS, rounds
            try:
                counted_render(params, f"interior_cutout detail=1 nee=False {bounces} bounces, "
                                       f"{rounds} cutout rounds, {route}")
            finally:
                fused.TEX_CUTOUT_ROUNDS = saved
            assert (params.scene._fused is None) == (route == "wavefront"), route
            out[route] = aov_buffers(params)["COLOR"]
        label = f"interior_cutout detail=1 nee=False {bounces} bounces {rounds} rounds"
        held = bounces >= CUTOUT_MEAN_BOUNCES  # below, logged: the pass-throughs spend bounces
        frames[label + " vs wavefront"] = mean_gap(out["fused"], out["wavefront"], label, held)
    return frames, launches, recorded


def tap_bound_ms(hit, mats, pool, active):
    """The least time of one tap_rows launch (HBM bytes; it does no walk):
    the hit rows its 12 output rows depend on (H_HIT, H_MAT and the 3 of
    H_N; the 2 uv rows when it taps; H_TAN and H_BS when it normal-maps:
    read_hit loads 13 rows, but H_POS, H_GN, H_FRONT and H_DS feed none of
    tap_kernel's outputs), the distinct texel rows its taps touch
    (tap_texel_rows), its 12 rows written, the tables read once (the
    material rows and slot columns, the slot records, the sRGB table).
    Returns ((ms, what bounds it), distinct texel rows)."""
    from gatling_tpu_torch.ops import bounce as tb

    textured = sum(bit for name, bit in tb.TAP_BITS.items() if name in active)
    textured |= tb.TAP_OPACITY if "opacity" in active else 0
    mask = tb.tap_mask(textured, hit.shape[0], pool)
    texels, row_bytes = tap_texel_rows(mats, pool, hit, textured)
    hit_rows = 5 + (2 if mask else 0) + (4 if mask & tb.TAP_NORMAL else 0)
    tables = mats.packed_f.numel() + mats.packed_i.numel() + 14 * pool.count + 256
    nbytes = 4 * hit.shape[1] * (hit_rows + tb.TAP_ROWS) + texels.numel() * row_bytes + 4 * tables
    return _bound(nbytes, 0), texels.numel()


def phase_taps(device, tap_waves, clip_waves, cutout_calls):
    """Phase 3g: the kernels of 4h-4j on the waves those frames handed
    them. K4's taps alone (tap_rows) against tap_rows_ref on 4h's peel
    waves and 4j's re-trace waves, every row (the opacity's included)
    bit-equal on every hit ray; K3 and K4 on 4i's clipped peel waves
    against their twins (H_HIT, H_MAT and state rows 12-15 bit-equal on
    every ray, the other rows within tolerance on 99.9 %), as 3c holds
    them; K3 on 4j's masked re-trace waves against its twin. Each timed
    (CUDA events, medians) beside its twin, with its bound. Returns
    {wave: numbers}."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.split_ref import H_HIT, trace_ref

    out, errs = {}, dict(taps=0.0, k3=0.0, k4=0.0)
    for label, (hit, mats, pool, active) in tap_waves:
        got, want = tb.tap_rows(hit, mats, pool, active), tb.tap_rows_ref(hit, mats, pool, active)
        torch.cuda.synchronize()
        on = hit[H_HIT] > 0.5
        bad = int((got.view(torch.int32) != want.view(torch.int32))[:, on].any(dim=0).sum())
        err = float((got - want)[:, on].abs().max()) if bool(on.any()) else 0.0
        bound, texels = tap_bound_ms(hit, mats, pool, active)
        out[label] = dict(rays=hit.shape[1], hit_rays=int(on.sum()), not_bit_equal=bad,
                          ms=event_ms(lambda: tb.tap_rows(hit, mats, pool, active)),
                          plain_ms=event_ms(lambda: tb.tap_rows_ref(hit, mats, pool, active)),
                          bound=bound, distinct_texel_rows=texels,
                          opacity="opacity" in active)
        log(f"taps {label}: {out[label]}")
        assert bad == 0, (label, bad)
        errs["taps"] = max(errs["taps"], err)
    for label, (trace, shade) in clip_waves.items():
        p, fs, state = trace
        hit = tb.trace_step(p, fs, state)
        twin = trace_ref(p, fs.tris, state, fs.walk, fs.cutout)
        hb, ho, n, herr = compare_hits(hit, twin)
        p, fs, st, chit, mats, pool, active, nee = shade
        got = st.clone()
        tb.shade_step(p, fs, got, chit, mats, pool, active, nee)
        ref = st.clone()
        split_twin(p, fs, ref, chit, mats, pool, active, nee)
        sb, so, _n, serr = compare(got, ref)
        out[f"clip_{label}"] = dict(
            rays=n, k3_not_bit_equal=hb, k3_outside=ho, k4_not_bit_equal=sb, k4_outside=so,
            clipped_hits=int((twin[H_HIT] > 0.5).sum() - (chit[H_HIT] > 0.5).sum()),
            k3=time_ms(lambda s: tb.trace_step(p, fs, s), state),
            k4=time_ms(lambda s: tb.shade_step(p, fs, s, chit, mats, pool, active, nee), st))
        log(f"peel clip_{label}: {out[f'clip_{label}']}, max abs err K3 {herr:.3g}, K4 {serr:.3g}")
        assert hb == 0 and sb == 0 and ho <= n * (1 - MIN_AGREE) and so <= n * (1 - MIN_AGREE)
        errs["k3"], errs["k4"] = max(errs["k3"], herr), max(errs["k4"], serr)
    for k, (p, fs, state) in enumerate(cutout_calls.of("trace_step")[1:]):
        hit = tb.trace_step(p, fs, state)
        twin = trace_ref(p, fs.tris, state, fs.walk, fs.cutout)
        hb, ho, n, herr = compare_hits(hit, twin)
        work = cluster_walk_work(p, fs, state, False)
        bound = k3_bound_ms(state, fs, hit.shape[0], work)
        out[f"retrace_round_{k}"] = dict(
            rays=n, alive=int((state[13] > 0.5).sum()), not_bit_equal=hb, outside=ho,
            ms=time_ms(lambda s: tb.trace_step(p, fs, s), state),
            plain_ms=time_ms(lambda s: trace_ref(p, fs.tris, s, fs.walk, fs.cutout), state, 3),
            bound=bound, walk_work=work)
        log(f"re-trace K3 round {k}: {out[f'retrace_round_{k}']}, max abs err {herr:.3g}")
        assert hb == 0 and ho <= n * (1 - MIN_AGREE)
        errs["k3"] = max(errs["k3"], herr)
    return out, errs


# 4k: dome lights and float texel pools. cornell_dome's sky is a half EXR
# (ZIP), sphere_field_dome's a float32 one, rotated 30 degrees about the
# scene's up axis (z) with an emission multiplier; interior_hdr_textured's
# floor a half EXR whose values reach 4 (scene/examples.py write_sky,
# hdr_floor)
DOME_SKY, SF_DOME_SKY, HDR_FLOOR = (2048, 1024), (4096, 2048), 2048
DOME_ROTATION = (0.0, 0.0, math.sin(math.pi / 12), math.cos(math.pi / 12))
DOME_EMISSION = (1.5, 1.4, 1.3)
# the dome pass on the card against its CPU run on the same final state:
# atan2 and acos round differently in the last bits on the two, which moves
# a tap next to the sun's edge across it, so a share of the rays is held
DOME_RTOL, DOME_ATOL, DOME_AGREE = 1e-4, 1e-6, 0.999
# passes timed back to back behind the device's sleep: about 60 PyTorch
# launches each, within the queue of pending launches (device_ms)
DOME_PASSES = 8


def write_dome_assets(tex_dir: str) -> dict:
    """The skies and cornell_dome.usda (a DomeLight prim pointing at the
    half sky), written at run time."""
    from gatling_tpu_torch.scene import examples as ex

    t0 = time.perf_counter()
    out = dict(sky=ex.write_sky(os.path.join(tex_dir, "sky.exr"), *DOME_SKY),
               sf_sky=ex.write_sky(os.path.join(tex_dir, "sky_f32.exr"), *SF_DOME_SKY,
                                   half=False))
    out["usda"] = ex.cornell_dome(tex_dir, "sky.exr")
    log(f"dome assets: {DOME_SKY} half EXR {os.path.getsize(out['sky'])} B, {SF_DOME_SKY} "
        f"float32 EXR {os.path.getsize(out['sf_sky'])} B, written in "
        f"{time.perf_counter() - t0:.2f} s")
    return out


def cornell_dome_params(device, usda: str, nee: bool, visible: bool, every_aov: bool = False):
    """cornell_dome: the Cornell box (open towards -y) under the half sky,
    loaded from its .usda as the CLI loads it, 1200x1200, 16 spp, 8
    bounces; with NEE the bench's rect light; COLOR, or every AOV."""
    from gatling_tpu_torch import gi
    from gatling_tpu_torch.cli import load_gi_scene
    from gatling_tpu_torch.interface import AovId

    scene, desc, merged = load_gi_scene(usda, device, dict(
        spp=AOVS_SPP, maxBounces=AOVS_BOUNCES, nextEventEstimation=nee,
        domeLightCameraVisible=visible))
    assert scene.dome_light is not None and scene.dome_light.file_path.endswith("sky.exr")
    if nee:
        scene.add_light(bench_rect_light())
    binds = (all_aov_bindings(AOVS_RES, AOVS_RES) if every_aov else
             [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(AOVS_RES, AOVS_RES, 4))])
    return gi.GiRenderParams(scene=scene, camera=desc.first_camera(), aov_bindings=binds,
                             render_settings=merged)


def check_dome_pass(args, label) -> dict:
    """The dome pass on the card against its run on the CPU on the same
    final state: DOME_AGREE of the rays within DOME_RTOL / DOME_ATOL; its
    device time (device_ms over DOME_PASSES passes) and the bytes it moves at HBM rate (each
    state row it reads and the radiance written once, four texels of 12 B
    a missed ray)."""
    import torch

    from gatling_tpu_torch.render.fused import dome_pass
    from gatling_tpu_torch.render.integrator import DomeLightData

    radiance, state, dome, uniforms, visible = args
    got = dome_pass(radiance, state, dome, uniforms, visible)
    cpu_dome = DomeLightData(dome.texture.cpu(), dome.fallback.cpu())
    ref = dome_pass(radiance.cpu(), state.cpu(), cpu_dome, uniforms, visible)
    close = torch.isclose(got.cpu(), ref, rtol=DOME_RTOL, atol=DOME_ATOL).all(dim=1)
    missed = state[14] > 0.0
    r = radiance.shape[0]
    out = dict(rays=r, missed=int(missed.sum()), agree=float(close.float().mean()),
               max_abs_err=float((got.cpu() - ref).abs().max()),
               ms=device_ms(lambda: dome_pass(radiance, state, dome, uniforms, visible),
                            DOME_PASSES))
    out["bound"] = _bound(4 * r * (7 + 3 + 3) + 48 * out["missed"], 0)
    log(f"dome pass {label}: card against CPU {out}")
    assert out["agree"] >= DOME_AGREE, (label, out)
    return out


def srgb8(img):
    """The CLI's 8-bit PNG of a linear COLOR buffer (flipped, sRGB)."""
    import numpy as np

    from gatling_tpu_torch.cli import linear_to_srgb

    rgb = linear_to_srgb(img[::-1, :, :3])
    return np.clip(np.clip(rgb, 0, 1) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def interior_hdr_desc(tex_dir: str):
    """interior_hdr_textured: the interior with its floor texture a
    HDR_FLOOR^2 EXR (the whole pool float)."""
    from gatling_tpu_torch.scene.examples import hdr_floor, interior

    desc = interior(tex_dir=tex_dir)
    hdr_floor(desc, os.path.join(tex_dir, "floor_hdr.exr"), size=HDR_FLOOR)
    return desc


def cornell_hdr_params(device, tex_dir: str):
    """The Cornell box with every base colour a 64x64 EXR checker whose
    values reach 4 (a float pool on resident tables: K4's FLT instance
    over the resident tree), 1200x1200, 2 spp, 3 bounces."""
    import numpy as np

    from gatling_tpu_torch import imgio
    from gatling_tpu_torch.scene.stage import load_scene

    c = (np.arange(64)[:, None] // 8 + np.arange(64)[None, :] // 8) % 2
    img = np.stack([np.where(c, 4.0, 0.2), np.where(c, 2.5, 0.4), np.where(c, 0.6, 1.5),
                    np.ones_like(c)], -1).astype(np.float32)
    path = os.path.join(tex_dir, "checker_hdr.exr")
    imgio.write_image_file(path, img)
    desc = load_scene(CORNELL)
    texture_every_material(desc.materials, "diffuseColor", path)
    return desc_params(device, desc, FULL_RES, merged_settings(desc, spp=2, maxBounces=3))


def phase_dome(device, tex_dir: str):
    """Phase 4k: dome lights and float texel pools through gi.render, a
    first and a warm frame each with the kernels' launches: cornell_dome
    (K1; NEE off and on, camera-visible and not; the invisible frame
    darker only where a camera ray missed, bit-equal elsewhere), once
    through the CLI (its PNG the gi frame's within one code),
    sphere_field_dome (K2, instanced), cornell_aovs_dome (every AOV: the
    wavefront's K5/K6 and the dome on the miss; the fused NEE frame's mean
    against it within MEAN_SIGMAS), interior_hdr_textured (K3 and K4's
    FLT instance, no texture stage) and interior_hdr_first_hit (K4t's FLT
    instance); the dome pass on the card against its CPU run on three of
    the frames' final states. Returns (frame numbers, launches by frame,
    {case: (tables, static, recorded waves, nee)} for 3h, the tap waves of
    3h, the dome pass numbers)."""
    import numpy as np

    from gatling_tpu_torch import cli, gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render.material import MI_OPACITY_CH, MI_OPACITY_TEX, MaterialTable
    from gatling_tpu_torch.scene.examples import sphere_field

    assets = write_dome_assets(tex_dir)
    frames, launches, replay, passes = {}, {}, {}, {}
    imgs = {}
    for nee in (False, True):
        for visible in (True, False):
            label = f"cornell_dome{'_nee' if nee else ''}{'' if visible else '_invisible'}"
            params = cornell_dome_params(device, assets["usda"], nee, visible)
            with KernelCalls(1, ("dome_pass",)) as dp:
                img, frames[label], launches[label] = first_and_warm(params, label, {"K1"})
            assert params.scene._fused_static.n_clusters == 0  # resident: K1
            assert np.isfinite(img).all() and (img >= 0).all() and img[..., :3].mean() > 0.01
            imgs[label] = img
            if visible == nee:  # NEE on and visible, NEE off and invisible
                passes[label] = check_dome_pass(dp.of("dome_pass")[0], label)
        vis, inv = imgs[f"cornell_dome{'_nee' if nee else ''}"], imgs[
            f"cornell_dome{'_nee' if nee else ''}_invisible"]
        diff = vis[..., :3] - inv[..., :3]
        changed = float((diff != 0).any(-1).mean())
        log(f"cornell_dome nee={nee}: camera-invisible frame differs on {changed:.4f} of pixels "
            f"(camera rays that missed), by at most {float(diff.max()):.4f}")
        assert (diff >= 0).all() and 0.0 < changed < 0.5, (nee, changed)

    # the CLI on the .usda that holds the DomeLight prim
    png = os.path.join(tex_dir, "cornell_dome.png")
    for k in tb.launches:
        tb.launches[k] = 0
    t0 = time.perf_counter()
    rc = cli.main([assets["usda"], png, "--image-width", str(AOVS_RES), "--image-height",
                   str(AOVS_RES), "--spp", str(AOVS_SPP), "--max-bounces", str(AOVS_BOUNCES),
                   "--device", str(device)])
    cli_s = time.perf_counter() - t0
    cli_img = imgio.load_image_file(png)[..., :3].astype(np.int32)
    same = float((np.abs(cli_img - srgb8(imgs["cornell_dome"])) <= 1).all(-1).mean())
    log(f"cornell_dome through the CLI: rc {rc}, {cli_s:.2f} s, K1 launches {tb.launches['K1']}, "
        f"{same:.6f} of pixels within one code of the gi frame's sRGB")
    assert rc == 0 and tb.launches["K1"] > 0 and same >= 0.999
    frames["cornell_dome_cli_s"] = cli_s

    # sphere_field_dome: the float32 sky, rotated, scaled
    params = desc_params(device, sphere_field(), SF_RES, dict(
        spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True))
    dome = gi.giCreateDomeLight(params.scene, assets["sf_sky"])
    gi.giSetDomeLightRotation(dome, DOME_ROTATION)
    gi.giSetDomeLightBaseEmission(dome, DOME_EMISSION)
    with KernelCalls(1, ("dome_pass",)) as dp:
        img, frames["sphere_field_dome"], launches["sphere_field_dome"] = first_and_warm(
            params, f"sphere_field_dome {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee",
            {"K2"})
    assert params.scene._fused_static.instanced and np.isfinite(img).all() and (img >= 0).all()
    passes["sphere_field_dome"] = check_dome_pass(dp.of("dome_pass")[0], "sphere_field_dome")

    # cornell_aovs_dome: the wavefront, every AOV; the fused frame of the
    # same samples against it
    params = cornell_dome_params(device, assets["usda"], True, True, every_aov=True)
    desc = f"cornell_aovs_dome {AOVS_RES}^2 {AOVS_SPP}spp {AOVS_BOUNCES} bounces nee, every AOV"
    _aovs, first, _ = timed_aov_render(params, desc + " (first frame)")
    aovs, warm, lc = timed_aov_render(params, desc + " (warm)")
    assert lc["K5"] > 0 and lc["K6"] > 0, lc
    assert all(lc[k] == 0 for k in ("K1", "K2", "K3", "K4", "K4f", "K7", "K8")), lc
    check_aovs(aovs, params, "cornell_aovs_dome")
    frames["cornell_aovs_dome"] = dict(first_s=first, warm_s=[warm])
    launches["cornell_aovs_dome"] = lc
    frames["cornell_dome_vs_wavefront"] = mean_gap(imgs["cornell_dome_nee"], aovs[AovId.COLOR],
                                                   "cornell_dome_nee against cornell_aovs_dome")

    # interior_hdr_textured: K3 and K4's FLT instance; its waves for 3h
    hdr = interior_hdr_desc(tex_dir)
    params = desc_params(device, hdr, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                   nextEventEstimation=True))
    label = f"interior_hdr_textured {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee"
    img, frames["interior_hdr_textured"], lc = first_and_warm(params, label, {"K3", "K4f"})
    assert split_ref.stage_calls == 0 and np.isfinite(img).all() and (img >= 0).all()
    pool = params.scene._texture_pool
    assert not pool.packed and pool.texels.shape[0] > HDR_FLOOR ** 2, pool.texels.shape
    launches["interior_hdr_textured"] = lc
    waves, _ = record_fused_waves(gi_frame(params))
    replay["interior_hdr_textured"] = (params.scene._fused, params.scene._fused_static, waves,
                                       True)
    log(f"interior_hdr_textured: a float pool of {pool.texels.shape[0]} texels "
        f"({pool.texels.numel() * 4} B) over {pool.count} slots")

    # interior_hdr_first_hit: K4t's FLT instance at the peel
    settings = merged_settings(hdr, spp=SF_SPP, maxBounces=SF_BOUNCES, nextEventEstimation=True)
    params = fh_params(device, hdr, SF_RES, settings)
    bufs, frames["interior_hdr_first_hit"], lc, calls = frame_pair(
        params, f"interior_hdr_first_hit {SF_RES}^2 {SF_SPP}spp {SF_BOUNCES} bounces nee",
        {"K3", "K4f", "K4tf"}, record=4)
    assert lc["K4tf"] == SF_SPP and lc["K3"] == lc["K4f"] > SF_SPP, lc
    # an HDR base colour reaches 4: the albedo's diffuse part with it
    frames["interior_hdr_first_hit"]["hit_share"] = check_first_hit(
        bufs, "interior_hdr_first_hit", albedo_max=4.0 + ALBEDO_MAX)
    launches["interior_hdr_first_hit"] = lc
    hit, mats, pool, active = calls.of("tap_rows")[0]
    # the same wave's opacity tapped through the float pool: every
    # material's opacity the floor EXR's green channel (TAP_OPACITY)
    pi = mats.packed_i.clone()
    pi[:, MI_OPACITY_TEX] = int((pool.width == HDR_FLOOR).nonzero()[0, 0])
    pi[:, MI_OPACITY_CH] = 1
    tap_waves = [("interior_hdr_first_hit", (hit, mats, pool, active)),
                 ("interior_hdr_opacity", (hit, MaterialTable(mats.packed_f, pi), pool,
                                           (*active, "opacity")))]

    # K4's FLT instance over resident tables, for 3h
    params = cornell_hdr_params(device, tex_dir)
    waves, _ = record_fused_waves(gi_frame(params))
    assert params.scene._fused.walk is None and not params.scene._texture_pool.packed
    replay["cornell_hdr_textured"] = (params.scene._fused, params.scene._fused_static, waves,
                                      False)
    return frames, launches, replay, tap_waves, passes


def flt_entries(branch: dict, taps: dict, tap_errs: dict, launches: dict,
                formats: dict, formats2: dict, jpeg2000: dict, tiff: dict,
                legacy: dict) -> list[dict]:
    """The kernels-line entries of K4's and K4t's FLT instances from 3h's
    numbers: K4 on interior_hdr_textured's bounce-0 wave (the resident
    instance on cornell_hdr_textured's beside it, 4n's 16-bit grey pool),
    K4t on interior_hdr_first_hit's peel wave (with TAP_OPACITY beside
    it); launches per frame of 4k."""
    r, c = branch["interior_hdr_textured"], branch["cornell_hdr_textured"]
    t, o = taps["interior_hdr_first_hit"], taps["interior_hdr_opacity"]
    return [{
        "name": "shade_step (K4, FLT: a float texel pool)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3705 shade_step -> _shade_kernel :3370 "
                    "with the texture stage gatling_tpu/render/fused.py:241 _material_rows over "
                    "a float pool (gatling_tpu/render/texture.py:479-484)",
        "launches": launches["interior_hdr_textured"]["K4f"],
        "max_abs_err": max(r["err"], c["err"]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1], "library_ms": None, "rays": r["rays"], "alive": r["alive"],
        "texture_stage_ms": r["stage_ms"], "shadow_walk_work": r["k4_work"],
        "distinct_texel_rows": r["k4_texels"], "bound_ms_pr3_9_floor": r["k4_floor"][0],
        "ms_resident_cornell_hdr": c["ms"], "plain_ms_resident_cornell_hdr": c["plain_ms"],
        "bound_ms_resident_cornell_hdr": c["bound"][0],
        "distinct_texel_rows_resident_cornell_hdr": c["k4_texels"],
        "formats": formats_entry(formats, "K4f"),
        "formats2": formats_entry(formats2, "K4f"),
        "jpeg2000": formats_entry(jpeg2000, "K4f"),
        "tiff": formats_entry(tiff, "K4f"),
        "legacy": formats_entry(legacy, "K4f"),
    }, {
        "name": "tap_rows (K4t, FLT: a float texel pool)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/render/fused.py:241 _material_rows over a float pool "
                    "(gatling_tpu/render/texture.py:479-484) at the bounce-0 peel :481-490",
        "launches": launches["interior_hdr_first_hit"]["K4tf"],
        "max_abs_err": tap_errs["taps"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": None, "rays": t["rays"],
        "hit_rays": t["hit_rays"], "distinct_texel_rows": t["distinct_texel_rows"],
        "ms_opacity": o["ms"], "plain_ms_opacity": o["plain_ms"],
        "bound_ms_opacity": o["bound"][0],
    }]


# 4m: the content scene's .usdz frame against its .usda frame (the JAX
# package's tests/test_usdc.py:36 tolerance), and the share of pixels that
# may lie beyond it: the text layer skins the points its parser read in
# f64, the crate layer the f32 points it stores, and at full width a few
# near-ties move
CONTENT_RTOL, CONTENT_ATOL, CONTENT_BEYOND = 1e-4, 1e-5, 1e-3
CONTENT_FRAME = 12.0
# the content scene's shape (scene/examples.py write_content's defaults)
CONTENT = dict(figures=16, rings=48, segments=64, joints=24, tex_res=1024)
# a stage read back from a crate file against the parsed text: values
# within f32 rounding (the crate stores float and point attrs as f32)
STAGE_RTOL = 2.0 ** -23


def _values_close(x, y, rtol: float) -> bool:
    """Two attribute or metadata values: strings and tokens equal, dicts
    key by key, numbers (nested tuples and lists too, a matrix array flat
    or nested) within rtol, other lists element by element."""
    import numpy as np

    if isinstance(x, str) or isinstance(y, str) or x is None or y is None:
        return x == y
    if isinstance(x, dict) or isinstance(y, dict):
        return (isinstance(x, dict) and isinstance(y, dict) and x.keys() == y.keys()
                and all(_values_close(x[k], y[k], rtol) for k in x))
    try:
        a, b = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
    except (TypeError, ValueError):
        a = b = None
    if a is not None:
        return a.shape == b.shape and bool(np.all(np.abs(a - b) <= rtol * np.abs(a)))
    if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
        return len(x) == len(y) and all(_values_close(u, v, rtol) for u, v in zip(x, y))
    return x == y


def stage_diffs(a, b, rtol: float = STAGE_RTOL) -> list[str]:
    """Where two stages differ: the prim set, each prim's type, metadata
    and relationships, each attribute's type, value, metadata, connection
    and time samples (tests/test_usdc.py:17 and :306, widened to every
    field). Values compare within rtol."""
    pa, pb = {p.path: p for p in a.walk()}, {p.path: p for p in b.walk()}
    only = sorted(set(pa) ^ set(pb))
    out = [f"prims in one stage only: {only[:5]}"] if only else []
    if not _values_close(dict(a.meta), dict(b.meta), rtol):
        out.append(f"stage metadata {a.meta} != {b.meta}")
    for path in sorted(set(pa) & set(pb)):
        p, q = pa[path], pb[path]
        # the text parser records a specifier other than `def` only
        meta_p, meta_q = ({"specifier": "def", **x.meta} for x in (p, q))
        if p.type_name != q.type_name or not _values_close(meta_p, meta_q, rtol):
            out.append(f"{path}: type or metadata")
        if p.rels != q.rels:
            out.append(f"{path}: relationships {p.rels} != {q.rels}")
        if sorted(p.attrs) != sorted(q.attrs):
            out.append(f"{path}: attributes {sorted(set(p.attrs) ^ set(q.attrs))}")
        for name in sorted(set(p.attrs) & set(q.attrs)):
            u, v = p.attrs[name], q.attrs[name]
            ts_u, ts_v = u.time_samples or {}, v.time_samples or {}
            same = (u.type_name == v.type_name and str(u.connect or "") == str(v.connect or "")
                    and _values_close(u.value, v.value, rtol)
                    and _values_close(u.meta, v.meta, rtol)
                    and sorted(ts_u) == sorted(ts_v)
                    and all(_values_close(ts_u[t], ts_v[t], rtol) for t in ts_u))
            if not same:
                out.append(f"{path}.{name}")
    return out


class HostTimers:
    """Host seconds spent in functions, patched by (module or class,
    attribute name) for the length of a `with` block; a call nested in
    another of the same function counts once (the outermost)."""

    def __init__(self, **targets):
        self.targets, self.seconds, self.calls = targets, {k: 0.0 for k in targets}, {}
        self._saved, self._depth = {}, {k: 0 for k in targets}

    def __enter__(self):
        for key, (owner, attr) in self.targets.items():
            real = getattr(owner, attr)
            self._saved[key] = real

            def timed(*args, _key=key, _real=real, **kwargs):
                self._depth[_key] += 1
                t0 = time.perf_counter()
                try:
                    return _real(*args, **kwargs)
                finally:
                    self._depth[_key] -= 1
                    if self._depth[_key] == 0:
                        self.seconds[_key] += time.perf_counter() - t0
                        self.calls[_key] = self.calls.get(_key, 0) + 1
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for key, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._saved[key])
        return False


def split_parity(device, params, res: int, label: str) -> dict:
    """K3 and K4 (its FLT instance over a float pool) on the bounce-0 wave
    of a split frame gi.render rendered (NEE on): H_HIT/H_MAT and rows
    12-15 bit-equal to their twins on every ray, then both timed with
    their bounds."""
    import torch

    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops.split_ref import trace_ref

    fs, static, mats, tpool, active = split_tables(params)
    wave = wave_state(params.camera, res, res, SF_SPP, device, tiled=True)
    p0 = params_row(0, device)
    hit = trace_ref(p0, fs.tris, wave, fs.walk)
    twin = wave.clone()
    split_twin(p0, fs, twin, hit, mats, tpool, active, True)
    got_hit = tb.trace_step(p0, fs, wave)
    got = wave.clone()
    tb.shade_step(p0, fs, got, hit, mats, tpool, active, True)
    torch.cuda.synchronize()
    hb, ho, n, herr = compare_hits(got_hit, hit)
    sb, so, _n, serr = compare(got, twin)
    k4 = "K4" if tpool.packed else "K4f"
    log(f"parity {label} nee=True bounce 0: K3 {hb} rays with H_HIT/H_MAT not bit-equal, {ho} "
        f"of {n} outside rtol {RTOL}/atol {ATOL}, max abs err {herr:.3g}; {k4} {sb} rays with "
        f"rows 12-15 not bit-equal, {so} outside on rows 0-11, max abs err {serr:.3g}")
    assert hb == 0 and sb == 0 and ho <= n * (1 - MIN_AGREE) and so <= n * (1 - MIN_AGREE)
    work = cluster_walk_work(p0, fs, wave, False)
    k4_bound, k4_work, texels = k4_bound_ms(p0, fs, wave, hit, mats, tpool, active, True)
    t = dict(k3=time_ms(lambda s: tb.trace_step(p0, fs, s), wave),
             k3_twin=time_ms(lambda s: trace_ref(p0, fs.tris, s, fs.walk), wave, reps=2),
             k4=time_ms(lambda s: tb.shade_step(p0, fs, s, hit, mats, tpool, active, True), wave),
             k4_twin=time_ms(lambda s: split_twin(p0, fs, s, hit, mats, tpool, active, True),
                             wave, reps=2),
             k3_bound=k3_bound_ms(wave, fs, hit.shape[0], work), k4_bound=k4_bound,
             k3_err=herr, k4_err=serr, work=work, k4_work=k4_work, k4_texels=texels,
             rays=wave.shape[1], hits=int((hit[0] > 0.5).sum()))
    log(f"timing {label} nee=True bounce 0 at {t['rays']} rays ({t['hits']} hit; walk work "
        f"{work}): K3 {t['k3']:.3f} ms (twin {t['k3_twin']:.1f} ms, bound "
        f"{t['k3_bound'][0]:.4f} ms {t['k3_bound'][1]}); {k4} {t['k4']:.3f} ms (twin "
        f"{t['k4_twin']:.1f} ms, bound {t['k4_bound'][0]:.4f} ms {t['k4_bound'][1]}: shadow walk "
        f"work {k4_work}, {texels} distinct texel rows)")
    return t


def phase_content(device, work_dir: str, content: dict = CONTENT, res: int = SF_RES):
    """Phase 4m: USD content of production shape, built by the port alone
    (scene/examples.py write_content: 16 skinned figures of 6,144
    triangles, each bound to its own 24-joint chain Skeleton with 4
    influences a vertex and driven by its own SkelAnimation sampled at
    frames 1-24, one with a blend shape; a ground plane under a 1024^2
    8-bit PNG, a rect light, a camera; USD-authored MaterialX nodes: an
    ND_checkerboard_color3 base colour with ND_noise2d_float roughness, an
    ND_multiply_color3 of two image textures, an ND_frame_float x colour
    emission). The .usda is parsed by load_usda, saved by save_usdc, zipped
    with its PNGs into a .usdz (pack_usdz); the .usdc read back must equal
    the parsed stage within f32 rounding. cli.render_scene_file renders the
    .usdz on the card at frame 12 (512x512, 4 spp, 6 bounces, NEE: the
    bench's interior settings): the split bounce, K3 and K4 over the
    two-level walk (98,306 triangles, no mesh shared: each figure and the
    ground a placement of its own clusters, the object walk of the JAX
    package's rule), the composites baked into the 8-bit pool; a first
    frame, two warm frames, the host times of the crate read, the
    skinning, the baking and the pool build; the .usdz frame against the
    .usda frame; the frame at 128x128 against the wavefront's
    of the same samples; a gi.render at frame 13 lowers the animated
    material alone, its emission 13 x in2 exactly, the pool and the fused
    tables kept; then K3 and K4 on the frame's bounce-0 wave against their
    twins, timed with their bounds."""
    import numpy as np
    import torch

    from gatling_tpu_torch import cli, gi
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render import material as rmat
    from gatling_tpu_torch.render.texture import TextureManager
    from gatling_tpu_torch.scene import crate, examples, skel
    from gatling_tpu_torch.scene.usda import load_usda

    out = {}
    t0 = time.perf_counter()
    usda = examples.write_content(work_dir, **content)
    n_tris = content["figures"] * content["rings"] * content["segments"] * 2 + 2
    out["write_s"] = time.perf_counter() - t0
    usdz = os.path.join(work_dir, "content.usdz")
    packed = examples.pack_usdz(usda, usdz)
    out.update({k: packed[k] for k in ("parse_s", "save_s", "zip_s", "usdc_bytes")})
    with open(packed["usdc"], "rb") as f:
        data = f.read()
    with HostTimers(lz4=(crate, "lz4_decompress_block")) as tm:
        t0 = time.perf_counter()
        read_back = crate.read_usdc(data, path=packed["usdc"])
        out["crate_read_s"] = time.perf_counter() - t0
    out["crate_lz4_s"] = tm.seconds["lz4"]
    diffs = stage_diffs(packed["stage"], read_back)
    # the layout exporters write: minimal delta codes, match-bearing lz4
    # chunks, compressed int and float arrays (the pure-Python decoder's
    # match copies)
    adv = crate.write_usdc(packed["stage"], adversarial=True)
    out["adversarial_usdc"] = adv  # 4n (f) reads it again
    with HostTimers(lz4=(crate, "lz4_decompress_block")) as tm:
        t0 = time.perf_counter()
        adv_back = crate.read_usdc(adv)
        out["crate_read_adversarial_s"] = time.perf_counter() - t0
    out.update(crate_lz4_adversarial_s=tm.seconds["lz4"], adversarial_bytes=len(adv))
    diffs += stage_diffs(packed["stage"], adv_back)
    log(f"content: {os.path.getsize(usda)} B of .usda written in {out['write_s']:.2f} s, parsed "
        f"by load_usda in {out['parse_s']:.2f} s, saved by save_usdc ({out['usdc_bytes']} B) in "
        f"{out['save_s']:.3f} s, zipped in {out['zip_s']:.3f} s; the crate read back in "
        f"{out['crate_read_s']:.3f} s ({out['usdc_bytes'] / out['crate_read_s'] / 1e6:.1f} MB/s; "
        f"the pure-Python lz4 {out['crate_lz4_s']:.3f} s; literal blocks); the exporters' "
        f"layout ({out['adversarial_bytes']} B) in {out['crate_read_adversarial_s']:.3f} s "
        f"({out['adversarial_bytes'] / out['crate_read_adversarial_s'] / 1e6:.1f} MB/s; lz4 "
        f"{out['crate_lz4_adversarial_s']:.3f} s); against the parsed stage: {len(diffs)} "
        f"differences {diffs[:5]}")
    assert not diffs, diffs[:10]

    settings = dict(frame=CONTENT_FRAME, spp=SF_SPP, maxBounces=SF_BOUNCES,
                    nextEventEstimation=True)
    captured = []
    real_render = gi.render

    def capture(params):
        captured.append(params)
        return real_render(params)

    timers = HostTimers(crate_read=(crate, "read_usdc"), skinning=(skel, "maybe_skin_mesh"),
                        pool_build=(TextureManager, "build_pool"),
                        baking=(TextureManager, "_eval_bake"))
    for counts in (tb.launches,):
        for k in counts:
            counts[k] = 0
    split_ref.stage_calls = 0
    gi.render = capture
    try:
        with timers:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, scene = cli.render_scene_file(usdz, res, res, settings, device=str(device))
            out["first_frame_s"] = time.perf_counter() - t0
    finally:
        gi.render = real_render
    params = captured[0]
    img = img.copy()  # the render buffer itself: the next frames write into it
    out.update({f"host_{k}_s": v for k, v in timers.seconds.items()})
    st, pool = scene._fused_static, scene._texture_pool
    log(f"content .usdz at frame {CONTENT_FRAME:g}, {res}^2 {SF_SPP}spp {SF_BOUNCES} bounces "
        f"nee: first frame {out['first_frame_s']:.3f} s through cli.render_scene_file (host: "
        f"crate read {out['host_crate_read_s']:.3f} s, skinning {out['host_skinning_s']:.3f} s "
        f"in {timers.calls.get('skinning', 0)} meshes, pool build "
        f"{out['host_pool_build_s']:.3f} s of which baking {out['host_baking_s']:.3f} s in "
        f"{timers.calls.get('baking', 0)} composites); "
        f"{st.n_tris} triangles, {'instanced' if st.instanced else 'flattened'} "
        f"{'clustered' if st.clustered else 'resident'}, textured {st.textured_params}, "
        f"{pool.count} pool slots, 8-bit {pool.packed}; launches {dict(tb.launches)}")
    # every figure and the ground a placement of its own clusters: the
    # instance tables' object walk (ops/bounce.py instanced_arrays)
    assert st.n_tris == n_tris and st.clustered and st.textured
    assert st.n_instances == content["figures"] + 1, st.n_instances
    assert pool.count == 4 and pool.packed and split_ref.stage_calls == 0
    assert timers.calls["skinning"] == content["figures"] + 1, timers.calls
    assert timers.calls["baking"] == 3, timers.calls
    frames = []
    for k in range(2):
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        wimg, dt, _mr, launches = counted_render(params, f"content warm frame {k + 1}")
        frames.append(dt)
        assert launches["K3"] > 0 and launches["K4"] == launches["K3"], launches
        assert all(launches[n] == 0 for n in ("K1", "K2", "K4t", "K4f", "K4tf", "K5", "K6",
                                              "B1", "B2")), launches
        assert split_ref.stage_calls == 0
    out["warm_frame_s"], out["launches"] = frames, {k: launches[k] for k in ("K3", "K4")}
    rgb = wimg[..., :3]
    assert np.isfinite(rgb).all() and (rgb >= 0).all() and rgb.mean() > 0.01
    np.testing.assert_array_equal(wimg, img)  # the same samples on the same tables

    # the .usda frame: the same scene from the text layer
    timg, tscene = cli.render_scene_file(usda, res, res, settings, device=str(device))
    close = np.abs(img - timg) <= CONTENT_ATOL + CONTENT_RTOL * np.abs(timg)
    beyond = float((~close.all(-1)).mean())
    out["usdz_vs_usda_beyond"] = beyond
    log(f"content .usdz frame against the .usda frame: {beyond:.6f} of pixels beyond rtol "
        f"{CONTENT_RTOL} / atol {CONTENT_ATOL} (held under {CONTENT_BEYOND}); max abs diff "
        f"{float(np.abs(img - timg).max()):.3g}; means {img[..., :3].mean():.6f} / "
        f"{timg[..., :3].mean():.6f}")
    assert beyond < CONTENT_BEYOND
    del tscene, timg

    # the fused frame against the wavefront's at 128x128
    small = {}
    for route in ("fused", "wavefront"):
        sc, desc, merged = cli.load_gi_scene(usdz, str(device), settings)
        binds = [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(128, 128, 4))]
        if route == "wavefront":
            binds.append(gi.GiAovBinding(AovId.OBJECT_ID, gi.GiRenderBuffer(128, 128, 1, True),
                                         clear_value=-1))
        p = gi.GiRenderParams(scene=sc, camera=desc.first_camera(), aov_bindings=binds,
                              render_settings=merged)
        counted_render(p, f"content 128^2 {SF_SPP}spp {SF_BOUNCES} bounces nee, {route}")
        assert (sc._fused is None) == (route == "wavefront"), route
        small[route] = binds[0].render_buffer.data.copy()
    out["vs_wavefront"] = mean_gap(small["fused"], small["wavefront"], "content 128^2")

    # frame 13: the animated material alone is lowered anew
    glow = scene._material_index["/World/Looks/Glow"]
    in2 = scene.materials["/World/Looks/Glow"].nodes["/World/Looks/Glow/glow"].inputs["in2"]
    pool0, tris0 = scene._texture_pool, scene._fused.tris
    lowered = HostTimers(lower=(gi, "lower_material"))
    params.render_settings = dict(params.render_settings, frame=13.0)
    with lowered:
        img13, _dt, _mr, launches13 = counted_render(params, "content at frame 13")
    row = scene._material_table.packed_f[glow, rmat.MF_EMISSIVE:rmat.MF_EMISSIVE + 3]
    want = np.array([13.0 * float(c) for c in in2[:3]], np.float32)
    log(f"content at frame 13: {lowered.calls.get('lower', 0)} material(s) lowered anew, the "
        f"emission row {row.tolist()} (13 x in2 = {want.tolist()}); the pool kept "
        f"{scene._texture_pool is pool0}, the fused triangle tables kept "
        f"{scene._fused.tris is tris0}; launches {launches13}")
    assert lowered.calls.get("lower", 0) == 1 and np.array_equal(row, want)
    assert scene._texture_pool is pool0 and scene._fused.tris is tris0
    assert torch.equal(scene._fused.mats[glow, rmat.MF_EMISSIVE:rmat.MF_EMISSIVE + 3].cpu(),
                       torch.from_numpy(want))
    assert split_ref.stage_calls == 0 and not np.array_equal(img13, img)
    params.render_settings = dict(params.render_settings, frame=CONTENT_FRAME)
    gi.render(params)  # back at frame 12 for the bounce-0 wave

    # K3 and K4 on the frame's bounce-0 wave: parity and timing
    out["kernels"] = split_parity(device, params, res, "content")
    log(f"content: warm frames {', '.join(f'{x:.4f}' for x in frames)} s; launches a frame "
        f"{out['launches']}")
    return out


# ---------------------------------------------------------------------------
# 4n: the image formats, the asset readers and the native host library
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(HERE, "tests", "data", "imgio")
# the interior's base colours in (b) and (g): eight 8-bit fixtures, eight formats
FORMAT_TEXTURES = ("jpeg_420.jpg", "jpeg_444.jpg", "jpeg_progressive.jpg", "jpeg_grey.jpg",
                   "tga_raw.tga", "tga_rle.tga", "tiff_lzw_pred2.tif", "png_interlaced.png")
GREY16 = "png_grey16.png"  # (c): every material's roughness, a float pool
# the builders' earlier host times of the same work on the card's host
# (PERF.md section 5: E4, the NumPy build_bvh; F2, the pure-Python lz4
# crate read in the exporters' layout and the content pool build)
E4_BVH_S = {"interior_aovs": 0.967, "sphere_field_aovs": 2.868}
F2_CRATE_S, F2_POOL_S = 0.300, 0.671


def same_image(got, want) -> bool:
    """dtype and shape equal, values bit for bit (a bool array by value:
    Pillow's "1" arrays hold 255 for True)."""
    import numpy as np

    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    return np.array_equal(got, want) if got.dtype == bool else got.tobytes() == want.tobytes()


def formats_interior(device, tex_dir: str, files: list[str], roughness: str | None = None):
    """gi render parameters of the textured interior (512x512, 4 spp, 6
    bounces, NEE) whose materials' base colours are `files` in turn; with
    `roughness`, that texture's red channel every material's roughness."""
    from gatling_tpu_torch.scene.examples import interior
    from gatling_tpu_torch.scene.stage import ShaderNode

    desc = interior(tex_dir=tex_dir)
    for k, path in enumerate(sorted(desc.materials)):
        m = desc.materials[path]
        m.nodes[f"{path}/tex"].inputs["file"] = files[k % len(files)]
        if roughness:
            node = ShaderNode(path=f"{path}/roughness_tex", shader_id="UsdUVTexture",
                              inputs={"file": roughness, "sourceColorSpace": "raw"},
                              input_connections={})
            m.nodes[node.path] = node
            m.nodes[m.surface_node].input_connections["roughness"] = (node.path, "r")
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True))


def phase_formats(device, tex_dir: str, content_dir: str, content: dict, threaded: dict) -> dict:
    """Phase 4n: the image formats through the texture path, the asset
    readers, and the native host library's BVH build and lz4 (see the
    module docstring, (a)-(g)). Returns its numbers and launch counts."""
    import numpy as np
    import torch

    from gatling_tpu_torch import cli, gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.ops import bvh as bvhm
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render import assets
    from gatling_tpu_torch.render.texture import TextureManager
    from gatling_tpu_torch.scene import crate, examples

    out, launches = {}, {}
    # (a) every fixture on the card's host against Pillow's arrays
    ref = np.load(os.path.join(FIXTURES, "fixtures.npz"))
    blobs, decode_s = {}, {}
    for name in sorted(set(ref.files) - set(WEBP_FIXTURES) - set(J2K_FIXTURES)
                       - set(TIFF_FIXTURES) - set(LEGACY_FIXTURES)):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
        t0 = time.perf_counter()
        got = imgio.load_image(blobs[name])
        decode_s[name] = time.perf_counter() - t0
        assert same_image(got, ref[name]), (name, got.dtype, ref[name].dtype, got.shape)
    out["fixture_decode_s"] = decode_s
    log(f"formats (a): {len(decode_s)} fixtures decoded on the card's host, each bit-equal to "
        f"Pillow's array (fixtures.npz); host ms {({k: round(v * 1e3, 3) for k, v in decode_s.items()})}")

    # (b) eight formats as the interior's base colours against PNGs of their codes
    fmt_files = [os.path.join(FIXTURES, n) for n in FORMAT_TEXTURES]
    png_dir = os.path.join(tex_dir, "formats_png")
    os.makedirs(png_dir, exist_ok=True)
    png_files = []
    for name in FORMAT_TEXTURES:
        png_files.append(os.path.join(png_dir, os.path.splitext(name)[0] + ".png"))
        imgio.write_image_file(png_files[-1], imgio.load_image(blobs[name]))
    frames = {}
    for label, files in (("formats", fmt_files), ("formats_png", png_files)):
        params = formats_interior(device, tex_dir, files)
        counted_render(params, f"interior_{label} (first frame)")
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        pool = params.scene._texture_pool
        assert pool.packed and pool.count == len(FORMAT_TEXTURES), (pool.packed, pool.count)
        assert n["K3"] > 0 and n["K4"] == n["K3"] and n["K4f"] == 0 and split_ref.stage_calls == 0
        frames[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(frames["formats"][0], frames["formats_png"][0])
    log(f"formats (b): the interior with {len(FORMAT_TEXTURES)} base colours of 8 formats "
        f"against PNGs of their decoded codes: frames bit-equal {same}; COLOR mean "
        f"{frames['formats'][0][..., :3].mean():.6f}")
    assert same
    out["formats_kernels"] = split_parity(device, frames["formats"][1], SF_RES,
                                          "interior_formats")

    # (c) a 16-bit grey PNG as every roughness: a float pool, K4's FLT instance
    grey16 = os.path.join(FIXTURES, GREY16)
    params = formats_interior(device, tex_dir, fmt_files, roughness=grey16)
    counted_render(params, "interior_grey16 (first frame)")
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, dt, _mr, n = counted_render(params, "interior_grey16 (warm)")
    assert not params.scene._texture_pool.packed, "a 16-bit grey PNG makes the pool float"
    assert n["K4f"] == SF_BOUNCES and n["K3"] == SF_BOUNCES and n["K4"] == 0, n
    assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
    out["grey16_warm_frame_s"] = dt
    launches["interior_grey16"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    out["grey16_kernels"] = split_parity(device, params, SF_RES, "interior_grey16")
    small = {}
    for route in ("fused", "wavefront"):
        p = formats_interior(device, tex_dir, fmt_files, roughness=grey16)
        p.aov_bindings = [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(128, 128, 4))]
        if route == "wavefront":
            p.aov_bindings.append(gi.GiAovBinding(
                AovId.OBJECT_ID, gi.GiRenderBuffer(128, 128, 1, True), clear_value=-1))
        counted_render(p, f"interior_grey16 128^2, {route}")
        assert (p.scene._fused is None) == (route == "wavefront"), route
        small[route] = p.aov_bindings[0].render_buffer.data.copy()
    out["grey16_vs_wavefront"] = mean_gap(small["fused"], small["wavefront"],
                                          "interior_grey16 128^2")

    # (d) the content scene, its 1024^2 ground a JPEG from the port's writer
    usda = examples.retexture(os.path.join(content_dir, "content.usda"),
                              {"ground.png": ".jpg"}, "jpeg")
    with open(os.path.join(content_dir, "ground.jpg"), "rb") as f:
        ground = f.read()
    t0 = time.perf_counter()
    decoded = imgio.load_image(ground)
    out["ground_jpeg_decode_s"] = time.perf_counter() - t0
    timers = HostTimers(pool_build=(TextureManager, "build_pool"))
    settings = dict(frame=CONTENT_FRAME, spp=SF_SPP, maxBounces=SF_BOUNCES,
                    nextEventEstimation=True)
    with timers:
        cimg, scene = cli.render_scene_file(usda, SF_RES, SF_RES, settings, device=str(device))
    out["ground_jpeg_pool_build_s"] = timers.seconds["pool_build"]
    assert decoded.shape == (CONTENT["tex_res"],) * 2 + (4,) and scene._texture_pool.packed
    assert np.isfinite(cimg).all() and cimg[..., :3].mean() > 0.01
    log(f"formats (d): content with its 1024^2 ground a JPEG ({len(ground)} B) written by the "
        f"port: the ground decoded in {out['ground_jpeg_decode_s']:.4f} s on the card's host, "
        f"the pool built in {out['ground_jpeg_pool_build_s']:.4f} s (F2, the PNG ground: "
        f"{F2_POOL_S} s); COLOR mean {cimg[..., :3].mean():.6f}")
    del scene, cimg

    # (e) the native threaded BVHs of 4l against the NumPy twin
    out["bvh"] = {}
    for label in ("interior_aovs", "sphere_field_aovs"):
        soup, (arrays, order), native_s = threaded[label]["native_bvh"]
        t0 = time.perf_counter()
        twin, twin_order = bvhm.build_bvh_ref(*soup)
        twin_s = time.perf_counter() - t0
        assert np.array_equal(order, twin_order)
        for field in bvhm.BvhArrays._fields:
            a, b = getattr(arrays, field), getattr(twin, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (label, field)
        out["bvh"][label] = dict(native_s=native_s, twin_s=twin_s, nodes=len(arrays.skip),
                                 triangles=len(order), e4_numpy_s=E4_BVH_S[label])
        log(f"formats (e): {label}'s threaded BVH ({len(order)} triangles, {len(arrays.skip)} "
            f"nodes) built natively in {native_s:.4f} s on the card's host, the NumPy twin in "
            f"{twin_s:.4f} s (E4: {E4_BVH_S[label]} s), array for array equal")

    # (f) the exporters' crate layout through the native lz4 against the twin
    adv = content["adversarial_usdc"]
    blocks, real_lz4 = [], crate.lz4_decompress_block

    def capture_lz4(src, max_out):
        got = real_lz4(src, max_out)
        blocks.append((bytes(src), max_out, got))
        return got

    crate.lz4_decompress_block = capture_lz4
    try:
        t0 = time.perf_counter()
        crate.read_usdc(adv)
        out["crate_read_s"] = time.perf_counter() - t0
    finally:
        crate.lz4_decompress_block = real_lz4
    twin_lz4 = HostTimers(lz4=(crate, "lz4_decompress_block_ref"))
    with twin_lz4:
        assert all(crate.lz4_decompress_block_ref(src, m) == got for src, m, got in blocks)
    t0 = time.perf_counter()
    for src, m, _got in blocks:
        real_lz4(src, m)
    out.update(crate_lz4_native_s=time.perf_counter() - t0, crate_lz4_twin_s=twin_lz4.seconds["lz4"],
               crate_blocks=len(blocks), crate_bytes=len(adv), f2_crate_read_s=F2_CRATE_S)
    log(f"formats (f): 4m's crate file in the exporters' layout ({len(adv)} B, {len(blocks)} lz4 "
        f"blocks) read in {out['crate_read_s']:.4f} s through the native lz4 (F2, pure Python: "
        f"{F2_CRATE_S} s); the blocks alone {out['crate_lz4_native_s']:.4f} s natively, "
        f"{out['crate_lz4_twin_s']:.4f} s in the pure-Python twin, bytes equal")

    # (g) (b)'s textures served by a registered in-memory reader
    served = {f"mem://formats/{n}": blobs[n] for n in FORMAT_TEXTURES}

    class MemoryReader(assets.GiAssetReader):
        def open(self, path):
            data = served.get(path)
            return None if data is None else assets.GiAsset(data, len(data))

    gi.giRegisterAssetReader(MemoryReader())
    params = formats_interior(device, tex_dir, list(served))
    counted_render(params, "interior_formats_reader (first frame)")
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, _dt, _mr, n = counted_render(params, "interior_formats_reader (warm)")
    same = np.array_equal(img, frames["formats"][0])
    log(f"formats (g): the interior's textures through a registered in-memory asset reader: "
        f"frame bit-equal to (b)'s {same}")
    assert same and n["K3"] > 0
    launches["interior_formats_reader"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    out["launches"] = launches
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# 4p: the remaining image formats (BMP, GIF, DDS, PSD, QOI, Netpbm, 16-bit
# TGA, palette and JPEG-compressed TIFF, CMYK JPEG ...) through the texture
# path, and the tracer switches
# ---------------------------------------------------------------------------

# 4n's fixtures; 4p (a) decodes every other entry of fixtures.npz
FIRST_FIXTURES = ("jpeg_420.jpg", "jpeg_422.jpg", "jpeg_444.jpg", "jpeg_grey.jpg",
                  "jpeg_progressive.jpg", "jpeg_restart.jpg", "tga_raw.tga", "tga_rle.tga",
                  "tiff_lzw_pred2.tif", "tiff_deflate16.tif", "tiff_float.tif",
                  "png_interlaced.png", "png_rgb16.png", "png_grey16.png", "png_grey1.png")
# (b): twelve 8-bit slots of the new formats, ten base colours and two roughnesses
FORMATS2_8BIT = ("bmp_rgb24.bmp", "gif_palette.gif", "dds_bc1.dds", "dds_bc3.dds",
                 "dds_bc7.dds", "psd_rgb.psd", "qoi_rgba.qoi", "ppm_rgb.ppm", "tga_rgb16.tga",
                 "tiff_palette.tif", "tiff_jpeg.tif", "jpeg_cmyk.jpg")
# (c): float and bool images as every material's roughness (a float pool)
FORMATS2_FLOAT = ("pgm_grey16.pgm", "pfm_grey.pfm", "bmp_grey1.bmp")
BRUTE_RES = 64  # (e): the Cornell box through the wavefront with a forced tracer


def formats2_interior(device, tex_dir: str, base: list[str], rough: list[str]):
    """gi render parameters of the textured interior (512x512, 4 spp, 6
    bounces, NEE), its materials' base colours `base` in turn and their
    roughnesses the red channels of `rough` in turn."""
    from gatling_tpu_torch.scene.examples import interior
    from gatling_tpu_torch.scene.stage import ShaderNode

    desc = interior(tex_dir=tex_dir)
    for k, path in enumerate(sorted(desc.materials)):
        m = desc.materials[path]
        m.nodes[f"{path}/tex"].inputs["file"] = base[k % len(base)]
        node = ShaderNode(path=f"{path}/roughness_tex", shader_id="UsdUVTexture",
                          inputs={"file": rough[k % len(rough)], "sourceColorSpace": "raw"},
                          input_connections={})
        m.nodes[node.path] = node
        m.nodes[m.surface_node].input_connections["roughness"] = (node.path, "r")
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True))


def phase_formats2(device, tex_dir: str) -> dict:
    """Phase 4p: the remaining formats (see the module docstring, (a)-(e)).
    Returns its numbers and launch counts."""
    import numpy as np
    import torch

    from gatling_tpu_torch import cli, gi, imgio
    from gatling_tpu_torch.interface import AovId
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render.texture import TextureManager

    out, launches = {}, {}
    # (a) the new fixtures on the card's host against Pillow's arrays
    ref = np.load(os.path.join(FIXTURES, "fixtures.npz"))
    blobs, decode_s = {}, {}
    for name in sorted(set(ref.files) - set(FIRST_FIXTURES) - set(WEBP_FIXTURES)
                       - set(J2K_FIXTURES) - set(TIFF_FIXTURES) - set(LEGACY_FIXTURES)):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
        t0 = time.perf_counter()
        got = imgio.load_image(blobs[name])
        decode_s[name] = time.perf_counter() - t0
        assert same_image(got, ref[name]), (name, got.dtype, ref[name].dtype, got.shape)
    out["fixture_decode_s"] = decode_s
    log(f"formats2 (a): {len(decode_s)} fixtures of the remaining formats decoded on the card's "
        f"host, each bit-equal to Pillow's array (fixtures.npz); host ms "
        f"{({k: round(v * 1e3, 3) for k, v in decode_s.items()})}")

    # (b) twelve 8-bit slots of the new formats against PNGs of their codes
    files = [os.path.join(FIXTURES, n) for n in FORMATS2_8BIT]
    png_dir = os.path.join(tex_dir, "formats2_png")
    os.makedirs(png_dir, exist_ok=True)
    pngs = []
    for path in files:
        pngs.append(os.path.join(png_dir, os.path.basename(path) + ".png"))
        imgio.write_image_file(pngs[-1], imgio.load_image(blobs[os.path.basename(path)]))
    frames = {}
    for label, slots in (("formats2", files), ("formats2_png", pngs)):
        params = formats2_interior(device, tex_dir, slots[:10], slots[10:])
        timers = HostTimers(pool_build=(TextureManager, "build_pool"))
        with timers:
            counted_render(params, f"interior_{label} (first frame)")
        out[f"{label}_pool_build_s"] = timers.seconds["pool_build"]
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        pool = params.scene._texture_pool
        assert pool.packed and pool.count == len(FORMATS2_8BIT), (pool.packed, pool.count)
        assert n["K3"] == SF_BOUNCES and n["K4"] == SF_BOUNCES and n["K4f"] == 0, n
        assert split_ref.stage_calls == 0
        frames[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(frames["formats2"][0], frames["formats2_png"][0])
    log(f"formats2 (b): the interior with {len(FORMATS2_8BIT)} 8-bit slots of the new formats "
        f"against PNGs of their decoded codes: frames bit-equal {same}; COLOR mean "
        f"{frames['formats2'][0][..., :3].mean():.6f}")
    assert same and np.isfinite(frames["formats2"][0]).all()
    out["formats_kernels"] = split_parity(device, frames["formats2"][1], SF_RES,
                                          "interior_formats2")

    # (c) float and bool images as the roughnesses: a float pool, K4's FLT instance
    params = formats2_interior(device, tex_dir, files[:10],
                               [os.path.join(FIXTURES, n) for n in FORMATS2_FLOAT])
    timers = HostTimers(pool_build=(TextureManager, "build_pool"))
    with timers:
        counted_render(params, "interior_formats2_float (first frame)")
    out["formats2_float_pool_build_s"] = timers.seconds["pool_build"]
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, dt, _mr, n = counted_render(params, "interior_formats2_float (warm)")
    assert not params.scene._texture_pool.packed, "float and bool images make the pool float"
    assert n["K4f"] == SF_BOUNCES and n["K3"] == SF_BOUNCES and n["K4"] == 0, n
    assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
    out["formats2_float_warm_frame_s"] = dt
    launches["interior_formats2_float"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    out["grey16_kernels"] = split_parity(device, params, SF_RES, "interior_formats2_float")
    small = {}
    for route in ("fused", "wavefront"):
        p = formats2_interior(device, tex_dir, files[:10],
                              [os.path.join(FIXTURES, n) for n in FORMATS2_FLOAT])
        p.aov_bindings = [gi.GiAovBinding(AovId.COLOR, gi.GiRenderBuffer(128, 128, 4))]
        if route == "wavefront":
            p.aov_bindings.append(gi.GiAovBinding(
                AovId.OBJECT_ID, gi.GiRenderBuffer(128, 128, 1, True), clear_value=-1))
        counted_render(p, f"interior_formats2_float 128^2, {route}")
        assert (p.scene._fused is None) == (route == "wavefront"), route
        small[route] = p.aov_bindings[0].render_buffer.data.copy()
    out["float_vs_wavefront"] = mean_gap(small["fused"], small["wavefront"],
                                         "interior_formats2_float 128^2")

    # (d) the host times of (b)'s and (c)'s pool builds
    log(f"formats2 (d): pool builds on the card's host: 8-bit slots "
        f"{out['formats2_pool_build_s']:.4f} s (their PNG twins "
        f"{out['formats2_png_pool_build_s']:.4f} s), float slots "
        f"{out['formats2_float_pool_build_s']:.4f} s")

    # (e) GATLING_FUSED=0 with GATLING_TRACER forced: brute launches no kernel
    # (a request, not a fallback); bvh takes B1/B2
    saved = {k: os.environ.get(k) for k in ("GATLING_FUSED", "GATLING_TRACER")}
    settings = dict(spp=2, maxBounces=3, nextEventEstimation=True)
    try:
        os.environ["GATLING_FUSED"] = "0"
        for tracer in ("brute", "bvh"):
            os.environ["GATLING_TRACER"] = tracer
            (img, scene), dt, n = timed(lambda: cli.render_scene_file(
                CORNELL, BRUTE_RES, BRUTE_RES, settings, device=str(device)))
            assert scene._fused is None and scene._tracer == tracer
            assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
            if tracer == "brute":
                assert not n, n  # the plain Moller-Trumbore: no kernel of the port's
            else:
                assert n.get("B1", 0) > 0 and n.get("B2", 0) > 0, n
            out.setdefault("tracer_launches", {})[f"cornell_wavefront_{tracer}"] = n
            out[f"cornell_wavefront_{tracer}_s"] = dt
            log(f"formats2 (e): GATLING_FUSED=0 GATLING_TRACER={tracer}: the Cornell box "
                f"{BRUTE_RES}^2 through the wavefront in {dt:.4f} s, kernel launches {n}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["launches"] = launches
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# 4q: WebP (VP8 lossy, VP8L lossless, ALPH alpha, an animation's first
# frame) through the texture path
# ---------------------------------------------------------------------------

# 4n and 4p leave these to 4q; the 1024^2 ones fixtures.npz keeps as digests
WEBP_FIXTURES = ("webp_anim.webp", "webp_ground_1024.webp", "webp_lossless_1024.webp",
                 "webp_lossless_rgb.webp", "webp_lossless_rgba.webp", "webp_lossy_rgb.webp",
                 "webp_lossy_rgba.webp", "webp_rgba_1024.webp")
WEBP_1024 = ("webp_ground_1024.webp", "webp_rgba_1024.webp", "webp_lossless_1024.webp")
# (b): the interior's six 8-bit base-colour slots
WEBP_8BIT = ("webp_lossy_rgb.webp", "webp_lossy_rgba.webp", "webp_lossless_rgb.webp",
             "webp_lossless_rgba.webp", "webp_anim.webp", "webp_ground_1024.webp")


def array_digest(arr) -> bytes:
    """SHA-256 of an array's dtype, shape and bytes, a bool array by value
    (make_fixtures.py digest)."""
    import hashlib

    import numpy as np

    if arr.dtype == bool:
        arr = arr != 0
    return hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode()
                          + np.ascontiguousarray(arr).tobytes()).digest()


def webp_interior(device, tex_dir: str, base: list[str]):
    """gi render parameters of the textured interior (512x512, 4 spp, 6
    bounces, NEE), its materials' base colours `base` in turn."""
    from gatling_tpu_torch.scene.examples import interior

    desc = interior(tex_dir=tex_dir)
    for k, path in enumerate(sorted(desc.materials)):
        desc.materials[path].nodes[f"{path}/tex"].inputs["file"] = base[k % len(base)]
    return desc_params(device, desc, SF_RES, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                  nextEventEstimation=True))


def phase_webp(device, tex_dir: str) -> dict:
    """Phase 4q: WebP (see the module docstring, (a)-(c)). Returns its
    numbers and launch counts."""
    import numpy as np

    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render.texture import TextureManager

    out, launches = {}, {}
    # (a) the WebP fixtures on the card's host against Pillow's arrays or digests
    ref = np.load(os.path.join(FIXTURES, "fixtures.npz"))
    blobs, decode_s = {}, {}
    for name in WEBP_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
        t0 = time.perf_counter()
        got = imgio.load_image(blobs[name])
        decode_s[name] = time.perf_counter() - t0
        if name in WEBP_1024:
            assert array_digest(got) == ref[name].tobytes(), name
        else:
            assert same_image(got, ref[name]), (name, got.dtype, ref[name].dtype, got.shape)
    out["fixture_decode_s"] = decode_s
    log(f"webp (a): {len(decode_s)} WebP fixtures decoded on the card's host, each bit-equal "
        f"to Pillow's array (fixtures.npz; the 1024^2 ones by its SHA-256); host ms "
        f"{({k: round(v * 1e3, 3) for k, v in decode_s.items()})}")

    # (b) six WebP base colours against PNGs of their decoded codes
    files = [os.path.join(FIXTURES, n) for n in WEBP_8BIT]
    png_dir = os.path.join(tex_dir, "webp_png")
    os.makedirs(png_dir, exist_ok=True)
    pngs = []
    for path in files:
        pngs.append(os.path.join(png_dir, os.path.basename(path) + ".png"))
        imgio.write_image_file(pngs[-1], imgio.load_image(blobs[os.path.basename(path)]))
    frames = {}
    for label, slots in (("webp", files), ("webp_png", pngs)):
        params = webp_interior(device, tex_dir, slots)
        timers = HostTimers(pool_build=(TextureManager, "build_pool"))
        with timers:
            counted_render(params, f"interior_{label} (first frame)")
        out[f"{label}_pool_build_s"] = timers.seconds["pool_build"]
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        pool = params.scene._texture_pool
        assert pool.packed and pool.count == len(WEBP_8BIT), (pool.packed, pool.count)
        assert n["K3"] == SF_BOUNCES and n["K4"] == SF_BOUNCES and n["K4f"] == 0, n
        assert split_ref.stage_calls == 0
        frames[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(frames["webp"][0], frames["webp_png"][0])
    log(f"webp (b): the interior with {len(WEBP_8BIT)} WebP base colours (lossy RGB and RGBA, "
        f"lossless RGB and RGBA, an animation's first frame, the 1024^2 lossy ground) against "
        f"PNGs of their decoded codes: frames bit-equal {same}; COLOR mean "
        f"{frames['webp'][0][..., :3].mean():.6f}")
    assert same and np.isfinite(frames["webp"][0]).all()
    out["formats_kernels"] = split_parity(device, frames["webp"][1], SF_RES, "interior_webp")

    # (c) the host times: (b)'s pool build, the three 1024^2 decodes (median of 5)
    for name in WEBP_1024:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            imgio.load_image(blobs[name])
            times.append(time.perf_counter() - t0)
        out[f"decode_{name}_s"] = statistics.median(times)
    log(f"webp (c): host times: pool build {out['webp_pool_build_s']:.4f} s (its PNG twins "
        f"{out['webp_png_pool_build_s']:.4f} s); 1024^2 decodes "
        f"{({k: round(out[f'decode_{k}_s'], 4) for k in WEBP_1024})} s")
    out["launches"] = launches
    return out


def formats_entry(formats: dict, kernel: str) -> dict:
    """Phase 4n's numbers beside K3's, K4's or K4f's kernels-line entry."""
    t = formats["grey16_kernels" if kernel == "K4f" else "formats_kernels"]
    k = "k4" if kernel == "K4f" else kernel.lower()
    return {"launches_by_frame": {f: v[kernel] for f, v in formats["launches"].items()},
            "ms": t[k], "plain_ms": t[k + "_twin"], "bound_ms": t[k + "_bound"][0],
            "max_abs_err": t[k + "_err"]}


# ---------------------------------------------------------------------------
# 4r: JPEG 2000, and JPEG's arithmetic, lossless and block-smoothed
# processes, through the texture path
# ---------------------------------------------------------------------------

# 4n (a) and 4p (a) leave these to 4r; the 1024^2 one fixtures.npz keeps as a digest
J2K_FIXTURES = ("j2k_97_mct.jp2", "j2k_grey16.j2k", "j2k_ground_1024.jp2", "j2k_lossless.jp2",
                "j2k_pclr.jp2", "j2k_rgba_cdef.jp2", "j2k_tiled_rpcl.j2k", "jpeg_arith.jpg",
                "jpeg_arith_progressive.jpg", "jpeg_lossless.jpg", "jpeg_smoothed.jpg")
J2K_1024 = "j2k_ground_1024.jp2"
# (b): the interior's nine 8-bit base-colour slots
J2K_8BIT = ("j2k_lossless.jp2", "j2k_97_mct.jp2", "j2k_rgba_cdef.jp2", "j2k_tiled_rpcl.j2k",
            "j2k_pclr.jp2", "jpeg_arith.jpg", "jpeg_lossless.jpg", "jpeg_smoothed.jpg",
            J2K_1024)
J2K_GREY16 = "j2k_grey16.j2k"  # (c): every material's roughness, a float pool


def phase_jpeg2000(device, tex_dir: str) -> dict:
    """Phase 4r: JPEG 2000 and JPEG's other processes (see the module
    docstring, (a)-(d)). Returns its numbers and launch counts."""
    import numpy as np

    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render.texture import TextureManager

    out, launches = {}, {}
    # (a) the fixtures on the card's host against Pillow's arrays or digest
    ref = np.load(os.path.join(FIXTURES, "fixtures.npz"))
    blobs, decode_s = {}, {}
    for name in J2K_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
        t0 = time.perf_counter()
        got = imgio.load_image(blobs[name])
        decode_s[name] = time.perf_counter() - t0
        if name == J2K_1024:
            assert array_digest(got) == ref[name].tobytes(), name
        else:
            assert same_image(got, ref[name]), (name, got.dtype, ref[name].dtype, got.shape)
    out["fixture_decode_s"] = decode_s
    log(f"jpeg2000 (a): {len(decode_s)} JPEG 2000 and JPEG fixtures decoded on the card's host, "
        f"each bit-equal to Pillow's array (fixtures.npz; the 1024^2 ground by its SHA-256); "
        f"host ms {({k: round(v * 1e3, 3) for k, v in decode_s.items()})}")

    # (b) nine base colours against PNGs of their decoded codes
    files = [os.path.join(FIXTURES, n) for n in J2K_8BIT]
    png_dir = os.path.join(tex_dir, "jpeg2000_png")
    os.makedirs(png_dir, exist_ok=True)
    pngs = []
    for path in files:
        pngs.append(os.path.join(png_dir, os.path.basename(path) + ".png"))
        imgio.write_image_file(pngs[-1], imgio.load_image(blobs[os.path.basename(path)]))
    frames = {}
    for label, slots in (("jpeg2000", files), ("jpeg2000_png", pngs)):
        params = webp_interior(device, tex_dir, slots)
        timers = HostTimers(pool_build=(TextureManager, "build_pool"))
        with timers:
            counted_render(params, f"interior_{label} (first frame)")
        out[f"{label}_pool_build_s"] = timers.seconds["pool_build"]
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        pool = params.scene._texture_pool
        assert pool.packed and pool.count == len(J2K_8BIT), (pool.packed, pool.count)
        assert n["K3"] == SF_BOUNCES and n["K4"] == SF_BOUNCES and n["K4f"] == 0, n
        assert split_ref.stage_calls == 0
        frames[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(frames["jpeg2000"][0], frames["jpeg2000_png"][0])
    log(f"jpeg2000 (b): the interior with {len(J2K_8BIT)} base colours (JP2 5/3, 9/7 with MCT, "
        f"RGBA with cdef, a tiled RPCL codestream, a pclr palette, arithmetic, lossless and "
        f"block-smoothed JPEG, the 1024^2 9/7 ground) against PNGs of their decoded codes: "
        f"frames bit-equal {same}; COLOR mean {frames['jpeg2000'][0][..., :3].mean():.6f}")
    assert same and np.isfinite(frames["jpeg2000"][0]).all()
    out["formats_kernels"] = split_parity(device, frames["jpeg2000"][1], SF_RES,
                                          "interior_jpeg2000")

    # (c) the 16-bit grey JPEG 2000 as every roughness: a float pool, K4's FLT instance
    params = formats2_interior(device, tex_dir, files, [os.path.join(FIXTURES, J2K_GREY16)])
    timers = HostTimers(pool_build=(TextureManager, "build_pool"))
    with timers:
        counted_render(params, "interior_jpeg2000_grey16 (first frame)")
    out["jpeg2000_grey16_pool_build_s"] = timers.seconds["pool_build"]
    params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, dt, _mr, n = counted_render(params, "interior_jpeg2000_grey16 (warm)")
    assert not params.scene._texture_pool.packed, "an I;16 image makes the pool float"
    assert n["K4f"] == SF_BOUNCES and n["K3"] == SF_BOUNCES and n["K4"] == 0, n
    assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
    out["jpeg2000_grey16_warm_frame_s"] = dt
    launches["interior_jpeg2000_grey16"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    out["grey16_kernels"] = split_parity(device, params, SF_RES, "interior_jpeg2000_grey16")

    # (d) the host times: the pool builds, the 1024^2 decode (median of 5)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        imgio.load_image(blobs[J2K_1024])
        times.append(time.perf_counter() - t0)
    out[f"decode_{J2K_1024}_s"] = statistics.median(times)
    log(f"jpeg2000 (d): host times: pool builds {out['jpeg2000_pool_build_s']:.4f} s (their PNG "
        f"twins {out['jpeg2000_png_pool_build_s']:.4f} s), the grey16 roughness pool "
        f"{out['jpeg2000_grey16_pool_build_s']:.4f} s; the 1024^2 9/7 decode "
        f"{out[f'decode_{J2K_1024}_s']:.4f} s")
    out["launches"] = launches
    return out


# 4s: TIFF's codecs and layouts (4n (a) and 4p (a) leave these to 4s; the
# 1024^2 ones fixtures.npz keeps as digests)
# (b): the 8-bit variants, one slot a material of the interior's ten in
# their sorted order, the 1024^2 ZSTD ground (predictor 2) on /m_floor, the
# fifth; (c): the bilevel CCITT ones, whose bool images make the pool float
# (imgio.is_hdr, the JAX package's rule), with the float roughnesses
TIFF_8BIT = ("tiff_lzma_rgba.tif", "tiff_zstd_pred2.tif", "tiff_thunder.tif",
             "tiff_ycbcr420_lzw.tif", "tiff_zstd_ground_1024.tif", "tiff_orient6_lzw.tif",
             "tiff_planar16.tif", "tiff_ojpeg.tif")
TIFF_BILEVEL = ("tiff_g4.tif", "tiff_g3_2d_fill.tif", "tiff_mh.tif")
TIFF_FLOAT = ("tiff_float_zstd_pred3.tif", "tiff_grey16_lzma.tif")  # (c): the roughnesses
TIFF_1024 = ("tiff_zstd_ground_1024.tif", "tiff_g4_stencil_1024.tif")
TIFF_FIXTURES = tuple(sorted({*TIFF_8BIT, *TIFF_BILEVEL, *TIFF_FLOAT, *TIFF_1024}))


def phase_tiff(device, tex_dir: str) -> dict:
    """Phase 4s: TIFF's codecs and layouts (see the module docstring,
    (a)-(d)). Returns its numbers and launch counts."""
    import numpy as np

    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render.texture import TextureManager

    out, launches = {}, {}
    # (a) the fixtures on the card's host against Pillow's arrays or digests
    ref = np.load(os.path.join(FIXTURES, "fixtures.npz"))
    blobs, decode_s = {}, {}
    for name in TIFF_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
        t0 = time.perf_counter()
        got = imgio.load_image(blobs[name])
        decode_s[name] = time.perf_counter() - t0
        if name in TIFF_1024:
            assert array_digest(got) == ref[name].tobytes(), name
        else:
            assert same_image(got, ref[name]), (name, got.dtype, ref[name].dtype, got.shape)
    out["fixture_decode_s"] = decode_s
    log(f"tiff (a): {len(decode_s)} TIFF fixtures decoded on the card's host, each bit-equal "
        f"to Pillow's array (fixtures.npz; the 1024^2 ground and stencil by their SHA-256); "
        f"host ms {({k: round(v * 1e3, 3) for k, v in decode_s.items()})}")

    # (b) eight 8-bit base colours against PNGs of their decoded codes
    png_dir = os.path.join(tex_dir, "tiff_png")
    os.makedirs(png_dir, exist_ok=True)

    def png_twins(names):
        paths = []
        for name in names:
            paths.append(os.path.join(png_dir, name + ".png"))
            imgio.write_image_file(paths[-1], imgio.load_image(blobs[name]))
        return paths

    files = [os.path.join(FIXTURES, n) for n in TIFF_8BIT]
    pngs = png_twins(TIFF_8BIT)
    frames = {}
    for label, slots in (("tiff", files), ("tiff_png", pngs)):
        params = webp_interior(device, tex_dir, slots)
        timers = HostTimers(pool_build=(TextureManager, "build_pool"))
        with timers:
            counted_render(params, f"interior_{label} (first frame)")
        out[f"{label}_pool_build_s"] = timers.seconds["pool_build"]
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        pool = params.scene._texture_pool
        assert pool.packed and pool.count == len(TIFF_8BIT), (pool.packed, pool.count)
        assert n["K3"] == SF_BOUNCES and n["K4"] == SF_BOUNCES and n["K4f"] == 0, n
        assert split_ref.stage_calls == 0
        frames[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(frames["tiff"][0], frames["tiff_png"][0])
    log(f"tiff (b): the interior with {len(TIFF_8BIT)} base colours (LZMA RGBA, ZSTD with "
        f"predictor 2, ThunderScan, YCbCr 4:2:0 LZW, the 1024^2 ZSTD ground, Orientation 6 LZW, "
        f"16-bit planes, old-style JPEG) against PNGs of their decoded codes: frames bit-equal "
        f"{same}; COLOR mean "
        f"{frames['tiff'][0][..., :3].mean():.6f}")
    assert same and np.isfinite(frames["tiff"][0]).all()
    out["formats_kernels"] = split_parity(device, frames["tiff"][1], SF_RES, "interior_tiff")

    # (c) the bilevel CCITT files as the base colours, the float ZSTD and
    # 16-bit grey LZMA files as the roughnesses: a float pool, K4's FLT
    # instance; against PNGs of the bilevel images' codes
    rough = [os.path.join(FIXTURES, n) for n in TIFF_FLOAT]
    floats = {}
    for label, slots in (("tiff_float", [os.path.join(FIXTURES, n) for n in TIFF_BILEVEL]),
                         ("tiff_float_png", png_twins(TIFF_BILEVEL))):
        params = formats2_interior(device, tex_dir, slots, rough)
        timers = HostTimers(pool_build=(TextureManager, "build_pool"))
        with timers:
            counted_render(params, f"interior_{label} (first frame)")
        out[f"{label}_pool_build_s"] = timers.seconds["pool_build"]
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        assert not params.scene._texture_pool.packed, "F and I;16 images make the pool float"
        assert n["K4f"] == SF_BOUNCES and n["K3"] == SF_BOUNCES and n["K4"] == 0, n
        assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
        floats[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(floats["tiff_float"][0], floats["tiff_float_png"][0])
    log(f"tiff (c): the interior with the Group 4, Group 3 2D and Modified Huffman base colours "
        f"and float ZSTD / 16-bit LZMA roughnesses against PNGs of the bilevel codes: frames "
        f"bit-equal {same}")
    assert same
    out["grey16_kernels"] = split_parity(device, floats["tiff_float"][1], SF_RES,
                                         "interior_tiff_float")

    # (d) the host times: the pool builds, the 1024^2 decodes (median of 5)
    for name in TIFF_1024:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            imgio.load_image(blobs[name])
            times.append(time.perf_counter() - t0)
        out[f"decode_{name}_s"] = statistics.median(times)
    log(f"tiff (d): host times: pool builds {out['tiff_pool_build_s']:.4f} s (their PNG twins "
        f"{out['tiff_png_pool_build_s']:.4f} s), the float roughness pool "
        f"{out['tiff_float_pool_build_s']:.4f} s; 1024^2 decodes (median of 5) "
        + ", ".join(f"{n} {out[f'decode_{n}_s']:.4f} s" for n in TIFF_1024))
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# 4t: Pillow's legacy plugins (SGI, PCX/DCX, BLP, FTEX, Sun raster, ICNS,
# XPM, IM, SPIDER, FITS, McIdas and the rest) through the texture path
# ---------------------------------------------------------------------------

# (b) the 8-bit base colours (the 1024^2 SGI ground the fifth: /m_floor)
LEGACY_8BIT = ("pcx_vga.pcx", "dcx_rgb.dcx", "blp2_dxt1.blp", "blp1_jpeg.blp",
               "sgi_ground_1024.sgi", "ftex_dxt1.ftex", "sun_rle8.ras", "icns_it32.icns",
               "xpm_p.xpm", "im_rgb.im")
# (c) the roughnesses Pillow gives as "F" or "I" modes: a float pool
# (fits_m32.fits: big-endian floats, as the FITS standard writes them,
# which Pillow reads as little-endian: NaN and infinite texels among them)
LEGACY_FLOAT = ("spider_f.spi", "fits_m32.fits", "fits_16.fits", "mcidas_2.area", "im_f.im",
                "im_grey16.im")
LEGACY_1024 = "sgi_ground_1024.sgi"
# 4n (a) and 4p (a) leave these to 4t; the 1024^2 ground fixtures.npz keeps as a digest
LEGACY_FIXTURES = tuple(sorted({*LEGACY_8BIT, *LEGACY_FLOAT, "fli_brun.flc",
                                "msp_v2.msp", "gbr_rgba.gbr", "xvthumb.xv", "xbm_bits.xbm"}))


def write_pfm(path: str, img) -> None:
    """A grey PFM (Pillow's "F": rows bottom first, little-endian) of the
    float image img [H, W, 4] whose R, G and B are equal."""
    import numpy as np

    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"Pf\n%d %d\n-1.0\n" % (w, h) + np.ascontiguousarray(
            img[::-1, :, 0], "<f4").tobytes())


def phase_legacy(device, tex_dir: str) -> dict:
    """Phase 4t: Pillow's legacy plugins (see the module docstring,
    (a)-(d)). Returns its numbers and launch counts."""
    import numpy as np

    from gatling_tpu_torch import gi, imgio
    from gatling_tpu_torch.ops import split_ref
    from gatling_tpu_torch.render.texture import TextureManager

    out, launches = {}, {}
    # (a) the fixtures on the card's host against Pillow's arrays or digest
    ref = np.load(os.path.join(FIXTURES, "fixtures.npz"))
    blobs, decode_s, arrays = {}, {}, {}
    for name in LEGACY_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            blobs[name] = f.read()
        t0 = time.perf_counter()
        arrays[name] = got = imgio.load_image(blobs[name])
        decode_s[name] = time.perf_counter() - t0
        if name == LEGACY_1024:
            assert array_digest(got) == ref[name].tobytes(), name
        else:
            assert same_image(got, ref[name]), (name, got.dtype, ref[name].dtype, got.shape)
    out["fixture_decode_s"] = decode_s
    log(f"legacy (a): {len(decode_s)} fixtures of Pillow's legacy plugins decoded on the card's "
        f"host, each bit-equal to Pillow's array (fixtures.npz; the 1024^2 SGI ground by its "
        f"SHA-256); host ms {({k: round(v * 1e3, 3) for k, v in decode_s.items()})}")

    # (b) ten 8-bit base colours against PNGs of their decoded codes
    twin_dir = os.path.join(tex_dir, "legacy_twins")
    os.makedirs(twin_dir, exist_ok=True)
    pngs = []
    for name in LEGACY_8BIT:
        pngs.append(os.path.join(twin_dir, name + ".png"))
        imgio.write_image_file(pngs[-1], arrays[name])
    frames = {}
    for label, slots in (("legacy", [os.path.join(FIXTURES, n) for n in LEGACY_8BIT]),
                         ("legacy_png", pngs)):
        params = webp_interior(device, tex_dir, slots)
        timers = HostTimers(pool_build=(TextureManager, "build_pool"))
        with timers:
            counted_render(params, f"interior_{label} (first frame)")
        out[f"{label}_pool_build_s"] = timers.seconds["pool_build"]
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        pool = params.scene._texture_pool
        assert pool.packed and pool.count == len(LEGACY_8BIT), (pool.packed, pool.count)
        assert n["K3"] == SF_BOUNCES and n["K4"] == SF_BOUNCES and n["K4f"] == 0, n
        assert split_ref.stage_calls == 0
        frames[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(frames["legacy"][0], frames["legacy_png"][0])
    log(f"legacy (b): the interior with {len(LEGACY_8BIT)} base colours (PCX, DCX, BLP2 DXT1, "
        f"BLP1 JPEG, the 1024^2 SGI RLE ground, FTEX, Sun RLE, ICNS it32, XPM, IM) against PNGs "
        f"of their decoded codes: frames bit-equal {same}; COLOR mean "
        f"{frames['legacy'][0][..., :3].mean():.6f}")
    assert same and np.isfinite(frames["legacy"][0]).all()
    out["formats_kernels"] = split_parity(device, frames["legacy"][1], SF_RES, "interior_legacy")

    # (c) the float and I-mode files as the roughnesses (a float pool, K4's
    # FLT instance) against PFMs of the same floats
    twins = []
    for name in LEGACY_FLOAT:
        twins.append(os.path.join(twin_dir, name + ".pfm"))
        write_pfm(twins[-1], arrays[name])
        assert same_image(imgio.load_image_file(twins[-1]), arrays[name]), name
    base = [os.path.join(FIXTURES, n) for n in LEGACY_8BIT[:4]]
    floats = {}
    for label, rough in (("legacy_float", [os.path.join(FIXTURES, n) for n in LEGACY_FLOAT]),
                         ("legacy_float_pfm", twins)):
        params = formats2_interior(device, tex_dir, base, rough)
        timers = HostTimers(pool_build=(TextureManager, "build_pool"))
        with timers:
            counted_render(params, f"interior_{label} (first frame)")
        out[f"{label}_pool_build_s"] = timers.seconds["pool_build"]
        params.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
        img, dt, _mr, n = counted_render(params, f"interior_{label} (warm)")
        assert not params.scene._texture_pool.packed, "F and I images make the pool float"
        assert n["K4f"] == SF_BOUNCES and n["K3"] == SF_BOUNCES and n["K4"] == 0, n
        assert np.isfinite(img).all() and img[..., :3].mean() > 0.01
        floats[label] = (img, params)
        out[f"{label}_warm_frame_s"] = dt
        launches[f"interior_{label}"] = {k: n[k] for k in ("K3", "K4", "K4f")}
    same = np.array_equal(floats["legacy_float"][0], floats["legacy_float_pfm"][0])
    bad = int((~np.isfinite(arrays["fits_m32.fits"])).sum())
    log(f"legacy (c): the interior with SPIDER, FITS -32 ({bad} of "
        f"{arrays['fits_m32.fits'].size} texel channels NaN or infinite under Pillow's "
        f"little-endian read of its big-endian floats) and 16, McIdas, IM F and I;16 "
        f"roughnesses against PFMs of the same floats: frames bit-equal {same}")
    assert same and bad > 0
    out["grey16_kernels"] = split_parity(device, floats["legacy_float"][1], SF_RES,
                                         "interior_legacy_float")

    # (d) the host times: the pool builds, the 1024^2 decode (median of 5)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        imgio.load_image(blobs[LEGACY_1024])
        times.append(time.perf_counter() - t0)
    out[f"decode_{LEGACY_1024}_s"] = statistics.median(times)
    log(f"legacy (d): host times: pool builds {out['legacy_pool_build_s']:.4f} s (their PNG "
        f"twins {out['legacy_png_pool_build_s']:.4f} s), the float roughness pool "
        f"{out['legacy_float_pool_build_s']:.4f} s; the 1024^2 SGI decode (median of 5) "
        f"{out[f'decode_{LEGACY_1024}_s']:.4f} s")
    out["launches"] = launches
    return out


# 4o: the front ends (the gi surface, the delegate, checkpoints, the CLI's
# flags, multi-device rendering, the validation layer, the husk bridge)
FE_ID_RES = 256  # the OBJECT_ID frames of giDestroyMesh (the wavefront: K5/K6)


def zero_launches() -> None:
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import trace as tt

    for counts in (tb.launches, tt.launches):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import trace as tt

    return {k: v for k, v in {**tb.launches, **tt.launches}.items() if v}


def timed(fn):
    """(fn(), seconds to the device's end), the launch counts set to 0
    just before and read just after: (result, seconds, launches)."""
    import torch

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def gi_bench_light(scene):
    """The benchmark's rect light through the gi calls: the RectLight prim
    of examples.cornell_rect (bench_rect_light) as giCreateRectLight and
    its setters build it."""
    import numpy as np

    from gatling_tpu_torch import gi

    light = gi.giCreateRectLight(scene)
    gi.giSetRectLightOrigin(light, (0.0, 0.0, 0.9))
    gi.giSetRectLightTangents(light, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    gi.giSetRectLightDimensions(light, 0.8, 0.6)
    gi.giSetRectLightBaseEmission(light, np.float32([1.0, 0.9, 0.8]) * 4.0)
    gi.giSetRectLightDiffuseSpecular(light, 1.0, 1.0)
    return light


def delegate_of(desc, device, settings: dict):
    """A render delegate on `device` with the scene description synced and
    `settings` set (as a host sets them)."""
    from gatling_tpu_torch.hydra import get_renderer_plugin

    plugin = get_renderer_plugin()
    assert plugin.is_supported()
    delegate = plugin.create_render_delegate(device)
    for m in desc.meshes:
        delegate.sync_mesh(m)
    for mat in desc.materials.values():
        delegate.sync_material(mat)
    for light in desc.lights:
        delegate.sync_light(light)
    for k, v in settings.items():
        if delegate.render_settings.get(k) != v:
            delegate.set_render_setting(k, v)
    return delegate


def execute(delegate, camera, binding: str, buf, label: str):
    """One render pass of `binding` into `buf`: (pixels, seconds, launches)."""
    from gatling_tpu_torch.hydra import HdAovBinding

    rp = delegate.create_render_pass()
    _, dt, launches = timed(lambda: rp.execute(camera, [HdAovBinding(binding, buf)]))
    assert buf.converged
    log(f"4o {label}: {dt:.4f} s, launches {launches}")
    return buf.map().copy(), dt, launches


def phase_front_ends(device, tex_dir: str) -> dict:
    """Phase 4o: the front ends on the card. Returns its numbers."""
    import numpy as np
    import torch

    from gatling_tpu_torch import cli, gi
    from gatling_tpu_torch.interface import AovId, aov_bit
    from gatling_tpu_torch.parallel.sharding import make_mesh, render_fused_sharded
    from gatling_tpu_torch.render.fused import render_pixels_fused, spp_batch_size
    from gatling_tpu_torch.scene.examples import cornell_rect, interior, sphere_field
    from gatling_tpu_torch.scene.stage import load_scene

    out = {}
    usda = cornell_rect(os.path.join(tex_dir, "front_ends"))
    settings = dict(spp=16, maxBounces=8, nextEventEstimation=True)
    merged = cli.load_gi_scene(usda, device, dict(settings))[2]

    # (a) the Cornell box with the bench's rect light made by the gi calls,
    # through the delegate, against the CLI's frame of the RectLight prim
    (want, cli_scene), cli_s, cli_launches = timed(
        lambda: cli.render_scene_file(usda, FULL_RES, FULL_RES, settings, device=device))
    log(f"4o cli.render_scene_file cornell_rect {FULL_RES}^2 16spp 8 bounces NEE: {cli_s:.4f} s "
        f"(scene build included), launches {cli_launches}")
    image_checks(want, "4o cli cornell_rect")
    desc = load_scene(CORNELL)
    delegate = delegate_of(desc, device, merged)
    gi_bench_light(delegate.scene)
    buf = delegate.create_render_buffer(FULL_RES, FULL_RES)
    img, first_s, launches = execute(delegate, desc.first_camera(), "color", buf,
                                     "delegate cornell_rect first frame")
    assert np.array_equal(img, want), "the delegate's frame differs from the CLI's"
    k1 = settings["spp"] // spp_batch_size(FULL_RES * FULL_RES, settings["spp"]) * 8
    assert launches == {"K1": k1}, launches  # 64 at 1200^2: 8 waves of 2 samples
    out["delegate_cornell_launches"] = launches
    delegate.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    img, warm_s, _ = execute(delegate, desc.first_camera(), "color", buf,
                             "delegate cornell_rect warm frame")
    assert np.array_equal(img, want)
    gi_params = cornell_params(device, settings, [bench_rect_light()])
    _, gi_warm_s, _, _ = warm_render(gi_params, "4o gi cornell_nee (phase 4's frame)")
    assert np.array_equal(gi_params.aov_bindings[0].render_buffer.data, want)
    out.update(delegate_first_s=first_s, delegate_warm_s=warm_s, gi_warm_s=gi_warm_s,
               cli_first_s=cli_s)

    # (b) the textured interior through the delegate: K3 and K4, equal to gi
    idesc = interior(tex_dir=tex_dir)
    idelegate = delegate_of(idesc, device, dict(spp=SF_SPP, maxBounces=SF_BOUNCES,
                                                nextEventEstimation=True))
    ibuf = idelegate.create_render_buffer(SF_RES, SF_RES)
    execute(idelegate, idesc.first_camera(), "color", ibuf, "delegate interior first frame")
    idelegate.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    iimg, iwarm_s, ilaunches = execute(idelegate, idesc.first_camera(), "color", ibuf,
                                       "delegate interior warm frame")
    assert ilaunches == {"K3": 6, "K4": 6}, ilaunches
    ref = interior_params(device, tex_dir)
    gi.render(ref)
    assert np.array_equal(ref.aov_bindings[0].render_buffer.data, iimg)
    out.update(delegate_interior_launches=ilaunches, delegate_interior_warm_s=iwarm_s)

    # (c) the checkpoint at the full frame: 8 spp, save, load into a fresh
    # scene, 8 more, against 8 + 8 in one scene
    half = dict(settings, spp=8)
    ckpt = os.path.join(tex_dir, "front_ends", "cornell.npz")
    scene, cdesc, cmerged = cli.load_gi_scene(usda, device, dict(half))
    one = gi.GiRenderParams(scene=scene, camera=cdesc.first_camera(), render_settings=cmerged,
                            aov_bindings=[gi.GiAovBinding(AovId.COLOR,
                                                          gi.GiRenderBuffer(FULL_RES, FULL_RES))])
    gi.render(one)
    t0 = time.perf_counter()
    gi.giSaveCheckpoint(scene, ckpt)
    save_s = time.perf_counter() - t0
    gi.render(one)
    fresh, fdesc, fmerged = cli.load_gi_scene(usda, device, dict(half))
    t0 = time.perf_counter()
    offset = gi.giLoadCheckpoint(fresh, ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    two = gi.GiRenderParams(scene=fresh, camera=fdesc.first_camera(), render_settings=fmerged,
                            aov_bindings=[gi.GiAovBinding(AovId.COLOR,
                                                          gi.GiRenderBuffer(FULL_RES, FULL_RES))])
    gi.render(two)
    assert offset == 8 and fresh.sample_offset == scene.sample_offset == 16
    assert np.array_equal(two.aov_bindings[0].render_buffer.data,
                          one.aov_bindings[0].render_buffer.data), "the resumed frame differs"
    size = os.path.getsize(ckpt)
    log(f"4o checkpoint {FULL_RES}^2 COLOR: save {save_s:.4f} s, load {load_s:.4f} s, "
        f"{size} bytes (raw {FULL_RES * FULL_RES * 16} bytes); the resumed 8 + 8 frame "
        f"bit-equal to 16 in one scene")
    out.update(checkpoint_save_s=save_s, checkpoint_load_s=load_s, checkpoint_bytes=size)

    # (d) giDestroyMesh: the survivors' OBJECT_ID values, through K5/K6
    ddesc = load_scene(CORNELL)
    ddel = delegate_of(ddesc, device, dict(spp=1, maxBounces=2, nextEventEstimation=True))
    gi_bench_light(ddel.scene)
    ids = ddel.create_render_buffer(FE_ID_RES, FE_ID_RES, "Int32")
    before, _, _ = execute(ddel, ddesc.first_camera(), "objectId", ids, "OBJECT_ID before")
    doomed = next(m for m in ddel.scene.meshes if m.path.endswith("BackWall"))
    gi.giDestroyMesh(ddel.scene, doomed)
    after, _, dlaunches = execute(ddel, ddesc.first_camera(), "objectId", ids,
                                  "OBJECT_ID after giDestroyMesh")
    keep = (before != doomed.object_id) & (after >= 0)
    assert not (after == doomed.object_id).any() and keep.mean() > 0.5
    assert np.array_equal(after[keep], before[keep]), "a survivor's OBJECT_ID changed"
    assert dlaunches.get("K5", 0) > 0 and dlaunches.get("K6", 0) > 0, dlaunches
    out["destroy_mesh_launches"] = dlaunches

    # (e) parallelDevices 2 on this host: clamped to the cards present
    par, par_s, _ = timed(lambda: cli.render_scene_file(
        usda, FULL_RES, FULL_RES, dict(settings, parallelDevices=2), device=device)[0])
    assert np.array_equal(par, want), "parallelDevices=2 differs from 1"
    log(f"4o parallelDevices=2 on {torch.cuda.device_count()} card(s): bit-equal to 1 "
        f"({par_s:.4f} s, scene build included)")

    # (f) render_fused_sharded on [cuda:0, cuda:0]: tiles bit-equal to the
    # one-device frame, sample shards within RTOL/ATOL; both timed warm
    params = gi.GiRenderParams(scene=delegate.scene, camera=desc.first_camera(),
                               aov_bindings=[gi.GiAovBinding(AovId.COLOR, buf._gi)],
                               render_settings=dict(delegate.render_settings))
    config = gi._build_config(params, FULL_RES, FULL_RES, aov_bit(AovId.COLOR))
    delegate.scene.sample_offset = 0
    uniforms = gi.frame_uniforms(params, config)
    fs, static = delegate.scene._fused, delegate.scene._fused_static
    pix = torch.arange(FULL_RES * FULL_RES, device=device)

    def single():
        return render_pixels_fused(config, uniforms, fs, pix, config.spp, 0, with_stats=True)

    def sharded(n_tiles, n_spp):
        mesh = make_mesh(n_tiles, n_spp, [device] * (n_tiles * n_spp))
        return render_fused_sharded(config, uniforms, fs, static, None, mesh)

    times = {}
    for label, fn in (("one_device", single), ("two_tiles", lambda: sharded(2, 1)),
                      ("two_spp_shards", lambda: sharded(1, 2))):
        fn()
        (color, segs), dt, launches = timed(fn)
        times[label] = (color, segs, dt, launches)
        log(f"4o {label} on [cuda:0{', cuda:0' if label != 'one_device' else ''}]: {dt:.4f} s "
            f"warm, launches {launches}")
    c1, s1 = times["one_device"][:2]
    assert torch.equal(times["two_tiles"][0], c1) and torch.equal(times["two_tiles"][1], s1)
    cs, ss = times["two_spp_shards"][:2]
    err = float((cs - c1).abs().max())
    assert torch.allclose(cs, c1, rtol=RTOL, atol=ATOL) and torch.allclose(ss, s1, rtol=RTOL,
                                                                           atol=ATOL), err
    assert times["two_tiles"][3]["K1"] == 2 * times["one_device"][3]["K1"]
    out.update(one_device_s=times["one_device"][2], two_tiles_s=times["two_tiles"][2],
               two_spp_shards_s=times["two_spp_shards"][2], spp_shards_max_abs_err=err)

    # (g) GATLING_VALIDATE=1: every launch synchronised and checked, the
    # AOVs checked; the same bits
    delegate.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER
    os.environ["GATLING_VALIDATE"] = "1"
    try:
        img, val_s, vlaunches = execute(delegate, desc.first_camera(), "color", buf,
                                        "GATLING_VALIDATE=1 cornell_rect frame")
    finally:
        del os.environ["GATLING_VALIDATE"]
    assert np.array_equal(img, want) and vlaunches == {"K1": k1}, vlaunches
    out["validate_s"] = val_s

    # (h) the husk bridge: Solaris' command line through the port's CLI
    png = os.path.join(tex_dir, "front_ends", "husk.png")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "gatling_tpu_torch", "dist", "houdini",
                                      "husk_gatling.py"), usda, "-o", png, "--res", "256", "256",
         "--pixel-samples", "4", "--gatling:next-event-estimation", "--gatling:device",
         device.type],
        capture_output=True, text=True, timeout=300)
    husk_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    from gatling_tpu_torch import imgio

    pixels = np.asarray(imgio.load_image_file(png))
    assert pixels.shape[:2] == (256, 256) and pixels.max() > 100, pixels.shape
    log(f"4o husk bridge wrote {png} ({pixels.shape}) in {husk_s:.2f} s (a new process)")
    out["husk_s"] = husk_s

    # (i) registration compression of sphere_field's meshes
    for mode in ("1", "0"):
        os.environ["GATLING_COMPRESS_MESHES"] = mode
        try:
            sdesc = sphere_field()
            held = [m.mesh for m in sdesc.meshes]
            scene = gi.create_scene(device)
            t0 = time.perf_counter()
            for m in sdesc.meshes:
                scene.add_mesh(m)
            reg_s = time.perf_counter() - t0
        finally:
            del os.environ["GATLING_COMPRESS_MESHES"]
        sources = {id(m) for m in held}
        if mode == "1":
            from gatling_tpu_torch.scene.meshproc import CompressedMesh

            packed = {id(m.mesh): m.mesh for m in scene.meshes}
            assert len(packed) == len(sources)
            assert all(isinstance(c, CompressedMesh) for c in packed.values())
            nbytes = sum(len(b[0]) if b[3] else b[0].nbytes
                         for c in packed.values() for b in c.blobs.values() if b is not None)
            raw = sum(a.nbytes for m in {id(h): h for h in held}.values()
                      for a in vars(m).values() if isinstance(a, np.ndarray))
            out.update(compress_register_s=reg_s, compressed_bytes=nbytes, raw_bytes=raw)
            log(f"4o sphere_field registration: {len(sdesc.meshes)} meshes over "
                f"{len(sources)} sources, compressed in {reg_s:.4f} s, {nbytes} of {raw} bytes")
        else:
            out["plain_register_s"] = reg_s
            log(f"4o sphere_field registration with GATLING_COMPRESS_MESHES=0: {reg_s:.4f} s")
    return out


def phase_goldens(device, out_dir: str):
    """The committed graphical scenes that tests/test_torch_graphical.py
    renders, through gatling_tpu_torch.testing.run_graphical_test on the
    card at their own thresholds, each on the route the port picks
    (Camera.ClippingPlanes on the fused peel). Materials.GlassCoated's
    reference is a wavefront image and the port's route for it the fused
    K1: the harness reports its error components over the threshold and
    nothing else (golden_glass_coated in 4f holds its wavefront frame to
    both thresholds). Returns {scene: failures}."""
    from gatling_tpu_torch import testing

    out = {}
    for name in GOLDENS:
        path = os.path.join(HERE, "tests", "graphical", name, "scene.usda")
        t0 = time.perf_counter()
        failures = testing.run_graphical_test(path, os.path.join(out_dir, name), device)
        out[name] = failures
        log(f"golden {name} on the card: {failures or 'passed'} ({time.perf_counter() - t0:.2f} s)")
        if name == "Materials.GlassCoated":
            assert failures and all("error components" in f for f in failures), failures
        else:
            assert not failures, (name, failures)
    return out


# the goldens (tests/test_torch_graphical.py ROUTES): every committed scene
GOLDENS = ("Camera.ClippingPlanes", "Lights.Analytic", "MaterialX.ColorSpaces",
           "Materials.GlassCoated", "Materials.MtlxFrame", "Materials.MtlxViewDirection",
           "Mesh.PrimvarInterpolation", "Mesh.Skinned", "Render.AOVs", "Render.Empty1x1")


# the __global__ functions of csrc/, the longest first (one name ends another)
KERNEL_NAMES = ("intersect_tree_kernel", "occluded_tree_kernel", "shade_walk_kernel",
                "trace_walk_kernel", "cutout_draws_kernel", "onehot_fp32_kernel",
                "onehot_tf32_kernel", "cast_probe_kernel", "occluded_kernel", "closest_kernel",
                "bounce_kernel", "shade_kernel", "trace_kernel", "tap_kernel", "walk_kernel")


def content_entry(content: dict, kernel: str) -> dict:
    """Phase 4m's numbers beside K3's or K4's kernels-line entry: launches
    a warm frame, ms a launch on the bounce-0 wave, its twin's and its
    bound, the warm frames' seconds."""
    t, k = content["kernels"], kernel.lower()
    return {"launches": content["launches"][kernel], "ms": t[k], "plain_ms": t[k + "_twin"],
            "bound_ms": t[k + "_bound"][0], "bound_by": t[k + "_bound"][1],
            "max_abs_err": t[k + "_err"], "warm_frame_s": content["warm_frame_s"]}


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel of nvcc's -Xptxas -v report: its name
    with the template arguments (the flags 1/0, the volume mode 0-2) and
    its registers, stack frame and spill bytes."""
    import re

    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?(" + "|".join(KERNEL_NAMES)
                      + r")(I(?:L[bi]\d+E)+E)?", line)
        if m:
            flags = re.findall(r"L[bi](\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(flags)}>" if flags else "")
            stack = spill = regs = None
        elif name and "stack frame" in line:
            stack, spill = re.findall(r"(\d+) bytes (?:stack frame|spill stores)", line)[:2]
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, {stack} B stack frame, {spill} B spill "
                       "stores")
            name = None
    return out


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(HERE, "gatling_tpu_torch", "csrc", "bounce.cu")):
        print("chip_smoke: run from the root of a checkout (gatling_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")

    # 2. build
    from torch.utils.cpp_extension import is_ninja_available

    from concurrent.futures import ThreadPoolExecutor

    from gatling_tpu_torch import tools
    from gatling_tpu_torch.ops import bounce as tb
    from gatling_tpu_torch.ops import trace as tt

    from gatling_tpu_torch import native

    def build_native() -> float:
        t0 = time.perf_counter()
        native.library()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:  # every nvcc run at once (bounce.cu in parts), and g++
        builds = [pool.submit(mod.kernel) for mod in (tb, tt, tools)]
        native_build = pool.submit(build_native)
        libs = [b.result() for b in builds]
        native_s = native_build.result()
    log(f"built {', '.join(k.path.name for k in libs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {', '.join(f'{k.build_seconds:.1f}' for k in libs)} s; ninja available: "
        f"{is_ninja_available()}, not needed: nvcc is called directly); the native host "
        f"library (csrc/gatling_native.cpp, g++) loaded in {native_s:.1f} s")
    for k in libs:
        for line in ptxas_summary(k.ptxas_log):
            log(f"ptxas {k.path.name}: {line}")

    # 3. K1 against its twin; 3b. K2 against its twin
    t0 = time.perf_counter()
    max_err, times = phase_kernel(device)
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sf = sphere_field_setup(device)
    walk_err, walk_times, sorted_ms = phase_walk(device, sf)
    log(f"phase 3b: {time.perf_counter() - t0:.1f} s")

    # 4-5. main path; each kernel's launches are counted over one frame of
    # its path through gi.render: K1 the Cornell frame, K2 sphere_field's,
    # K3 and K4 the interior's
    t0 = time.perf_counter()
    rates, k1_launches = phase_renders(device)
    log(f"phases 4 and 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sf_rates, k2_launches = phase_sphere_field(device, sf)
    rates.update(sf_rates)
    log(f"phases 4b and 4c: {time.perf_counter() - t0:.1f} s")
    tex_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tex_")
    extra = write_textures(tex_tmp.name)
    t0 = time.perf_counter()
    tex_rates, split_launches, scenes = phase_interior(device, tex_tmp.name, extra)
    rates.update(tex_rates)
    log(f"phase 4d: {time.perf_counter() - t0:.1f} s")

    # 3c. K3 and K4 against their twins on the tables gi built for 4d
    t0 = time.perf_counter()
    k3_err, k4_err, split_times = phase_split(device, scenes)
    log(f"phase 3c: {time.perf_counter() - t0:.1f} s")

    # 4e. the wavefront integrator (every AOV) through gi.render: K5, K6;
    # 3d. K5-K8 against their twins on the waves of 4e's frames
    t0 = time.perf_counter()
    wave_times, wavefront_launches, waves = phase_wavefront(device, tex_tmp.name)
    log(f"phase 4e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trace_times = phase_trace(device, waves)
    small_waves = waves["interior_aovs_small"]
    del waves
    trace_times.update(phase_trace_streamed(device, tex_tmp.name))
    log(f"phase 3d: {time.perf_counter() - t0:.1f} s")

    # 4l. the wavefront above 8192 triangles (B1/B2) through gi.render, the
    # dynamic inputs and the backface rows; 3i. B1 and B2 against their
    # twins on 4l's waves, and beside K5/K6 on interior_aovs_small's
    t0 = time.perf_counter()
    threaded_frames, threaded_launches, threaded_waves = phase_threaded(device, tex_tmp.name, sf)
    log(f"phase 4l: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    threaded_times = phase_threaded_trace(device, threaded_waves, small_waves)
    del threaded_waves, small_waves
    log(f"phase 3i: {time.perf_counter() - t0:.1f} s")

    # 4f. glass, clearcoat, anisotropy and cutout through gi.render; 3e. the
    # branches against their twins on 4f's waves; P. the probes
    t0 = time.perf_counter()
    lobe_frames, lobe_launches, replay, hop_waves = phase_lobes(device, tex_tmp.name)
    log(f"phase 4f: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trace_times.update(phase_trace(device, hop_waves))
    del hop_waves
    log(f"phase 3d, the cutout shadow hops: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    branch = phase_branches(device, replay)
    del replay
    log(f"phase 3e: {time.perf_counter() - t0:.1f} s")

    # 4g. media through gi.render; 3f. the volume branches against their
    # twins on 4g's waves, rows 12-15, H_HIT and H_MAT on every ray
    t0 = time.perf_counter()
    vol_frames, vol_launches, replay = phase_volumes(device, tex_tmp.name)
    log(f"phase 4g: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vol_branch = phase_branches(device, replay, exact=True)
    del replay
    log(f"phase 3f: {time.perf_counter() - t0:.1f} s")

    # 4h-4j: the fused route's bounce-0 peel (first-hit AOVs, clipping) and
    # the textured cutout's re-trace; 3g: K4's taps alone, K3 and K4 on
    # their waves; the goldens through the port's harness
    t0 = time.perf_counter()
    fh_frames, fh_launches, tap_waves = phase_first_hit(device, tex_tmp.name)
    log(f"phase 4h: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    clip_frames, clip_launches, clip_waves = phase_clipping(device)
    log(f"phase 4i: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cut_frames, cut_launches, cut_calls = phase_textured_cutout(device, tex_tmp.name)
    log(f"phase 4j: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tap_waves += [(f"interior_cutout round {k}", args)
                  for k, args in enumerate(cut_calls.of("tap_rows"))]
    peel, peel_errs = phase_taps(device, tap_waves, clip_waves, cut_calls)
    del tap_waves, clip_waves, cut_calls
    log(f"phase 3g: {time.perf_counter() - t0:.1f} s")

    # 4k: dome lights and float texel pools through gi.render; 3h: K4's and
    # K4t's FLT instances against their twins on 4k's waves
    t0 = time.perf_counter()
    dome_frames, dome_launches, hdr_replay, hdr_taps, dome_passes = phase_dome(device,
                                                                               tex_tmp.name)
    log(f"phase 4k: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hdr_branch = phase_branches(device, hdr_replay, exact=True)
    hdr_tap_times, hdr_tap_errs = phase_taps(device, hdr_taps, {}, KernelCalls(0))
    del hdr_replay, hdr_taps
    log(f"phase 3h: {time.perf_counter() - t0:.1f} s")
    # 4m: USD content (skinned figures, a .usdz of a crate layer, MaterialX
    # graphs baked into the pool) through cli.render_scene_file: K3, K4
    t0 = time.perf_counter()
    content = phase_content(device, os.path.join(tex_tmp.name, "content"))
    log(f"phase 4m: {time.perf_counter() - t0:.1f} s")
    # 4n: the image formats through the texture path (K3, K4, K4f), the
    # asset readers, the native BVH build and lz4
    t0 = time.perf_counter()
    formats = phase_formats(device, tex_tmp.name, os.path.join(tex_tmp.name, "content"),
                            content, threaded_frames)
    log(f"phase 4n: {time.perf_counter() - t0:.1f} s")
    host = {"ground_jpeg_decode_s": formats["ground_jpeg_decode_s"],
            "ground_jpeg_pool_build_s": formats["ground_jpeg_pool_build_s"],
            "crate_read_exporters_layout_native_lz4_s": formats["crate_read_s"],
            **{f"bvh_build_native_{k}_s": v["native_s"] for k, v in formats["bvh"].items()},
            **{f"bvh_build_numpy_twin_{k}_s": v["twin_s"] for k, v in formats["bvh"].items()}}
    for k, v in host.items():
        log(f"4n host time {k}: {v:.4f} s on the card's host ({smi})")
    # 4o: the front ends (gi calls, the delegate, checkpoints, parallelDevices,
    # render_fused_sharded, GATLING_VALIDATE, the husk bridge)
    t0 = time.perf_counter()
    front = phase_front_ends(device, tex_tmp.name)
    for k, v in front.items():
        log(f"4o {k}: {v} ({smi})")
    log(f"phase 4o: {time.perf_counter() - t0:.1f} s")
    # 4p: the remaining image formats through the texture path (K3, K4, K4f)
    # and the tracer switches
    t0 = time.perf_counter()
    formats2 = phase_formats2(device, tex_tmp.name)
    for k in ("formats2_pool_build_s", "formats2_png_pool_build_s", "formats2_float_pool_build_s"):
        log(f"4p host time {k}: {formats2[k]:.4f} s on the card's host ({smi})")
    log(f"phase 4p: {time.perf_counter() - t0:.1f} s")
    # 4q: WebP through the texture path (K3, K4)
    t0 = time.perf_counter()
    webp_out = phase_webp(device, tex_tmp.name)
    for k in ("webp_pool_build_s", "webp_png_pool_build_s",
              *(f"decode_{n}_s" for n in WEBP_1024)):
        log(f"4q host time {k}: {webp_out[k]:.4f} s on the card's host ({smi})")
    log(f"phase 4q: {time.perf_counter() - t0:.1f} s")
    # 4r: JPEG 2000 and JPEG's arithmetic, lossless and smoothed processes
    # through the texture path (K3, K4, K4f)
    t0 = time.perf_counter()
    j2k_out = phase_jpeg2000(device, tex_tmp.name)
    for k in ("jpeg2000_pool_build_s", "jpeg2000_png_pool_build_s",
              "jpeg2000_grey16_pool_build_s", f"decode_{J2K_1024}_s"):
        log(f"4r host time {k}: {j2k_out[k]:.4f} s on the card's host ({smi})")
    log(f"phase 4r: {time.perf_counter() - t0:.1f} s")
    # 4s: TIFF's codecs (CCITT, LZMA, ZSTD, ThunderScan, old-style JPEG) and
    # layouts through the texture path (K3, K4, K4f)
    t0 = time.perf_counter()
    tiff_out = phase_tiff(device, tex_tmp.name)
    for k in ("tiff_pool_build_s", "tiff_png_pool_build_s", "tiff_float_pool_build_s",
              *(f"decode_{n}_s" for n in TIFF_1024)):
        log(f"4s host time {k}: {tiff_out[k]:.4f} s on the card's host ({smi})")
    log(f"phase 4s: {time.perf_counter() - t0:.1f} s")
    # 4t: Pillow's legacy plugins through the texture path (K3, K4, K4f)
    t0 = time.perf_counter()
    legacy_out = phase_legacy(device, tex_tmp.name)
    for k in ("legacy_pool_build_s", "legacy_png_pool_build_s", "legacy_float_pool_build_s",
              f"decode_{LEGACY_1024}_s"):
        log(f"4t host time {k}: {legacy_out[k]:.4f} s on the card's host ({smi})")
    log(f"phase 4t: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    goldens = phase_goldens(device, os.path.join(tex_tmp.name, "goldens"))
    tex_tmp.cleanup()
    log(f"goldens: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_launches, p1, p2, p2_library, stream_us = phase_probes(device)
    log(f"phase P: {time.perf_counter() - t0:.1f} s")
    launches = {"K1": k1_launches, "K2": k2_launches, **split_launches, **wavefront_launches}
    log(f"main path: kernel launches per frame {launches}; Mray/s {rates}; wavefront frame "
        f"seconds {wave_times}; advanced lobes and cutout: launches {lobe_launches}, frames "
        f"{lobe_frames}; media: launches {vol_launches}, frames {vol_frames}")
    new_launches = {**fh_launches, **{f"cornell_clip_{k}": v for k, v in clip_launches.items()},
                    **cut_launches}
    log(f"first-hit frames {fh_frames}; clipping frames {clip_frames}; textured-cutout frames "
        f"{cut_frames}; their launches {new_launches}; goldens {goldens}")
    log(f"dome and float-pool frames {dome_frames}; their launches {dome_launches}; the dome "
        f"pass {dome_passes}")
    shown = {k: {f: x for f, x in v.items() if f != "native_bvh"}
             for k, v in threaded_frames.items()}
    log(f"the wavefront above 8192 triangles, dynamic inputs and backface rows: frames "
        f"{shown}; their launches {threaded_launches}")
    log(f"formats: launches {formats['launches']}; 16-bit grey against the wavefront "
        f"{formats['grey16_vs_wavefront']}")
    log(f"webp: launches {webp_out['launches']}")
    log(f"jpeg2000: launches {j2k_out['launches']}")
    log(f"tiff: launches {tiff_out['launches']}")
    log(f"legacy: launches {legacy_out['launches']}")
    log(f"formats2: launches {formats2['launches']}, with forced tracers "
        f"{formats2['tracer_launches']}; float slots against the wavefront "
        f"{formats2['float_vs_wavefront']}")
    taps = peel["cornell_first_hit"]

    k2 = walk_times[("instanced", "generated", False)]
    it, ct = split_times["interior"], split_times["cornell_textured"]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "bounce_step (K1, resident)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3192 (resident branch)",
        "launches": launches["K1"],
        "max_abs_err": max_err,
        "ms": times[False][0],
        "plain_ms": times[False][1],
        "bound_ms": times[False][2][0],
        "bound_by": times[False][2][1],
        "library_ms": None,
        "bound_ms_brute_force": times[False][3][0],
        "walk_work": times[False][4],
        "ms_nee": times[True][0],
        "plain_ms_nee": times[True][1],
        "bound_ms_nee": times[True][2][0],
        "bound_ms_brute_force_nee": times[True][3][0],
        "walk_work_nee": times[True][4],
    }, {
        "name": "bounce_step_walk (K2, clustered + instanced)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3192 (clustered+instanced branch: "
                    "_trace_clustered_matrix :1513, _trace_clustered_occluded :2002)",
        "launches": launches["K2"],
        "max_abs_err": walk_err,
        "ms": k2[0],
        "plain_ms": k2[1],
        "bound_ms": k2[2][0],
        "bound_by": k2[2][1],
        "library_ms": None,
        "bound_ms_cluster_floor": k2[3][0],
        "walk_work": k2[4],
        "ms_by_case": {f"{t}/{o}/nee={n}": v[0] for (t, o, n), v in walk_times.items()},
        "plain_ms_by_case": {f"{t}/{o}/nee={n}": v[1] for (t, o, n), v in walk_times.items()},
        "bound_ms_by_case": {f"{t}/{o}/nee={n}": v[2][0] for (t, o, n), v in walk_times.items()},
        "bound_ms_cluster_floor_by_case": {f"{t}/{o}/nee={n}": v[3][0]
                                           for (t, o, n), v in walk_times.items()},
        "bounces_1_5_ms_unsorted_sorted_sort": {f"{t}/nee={n}": v
                                                for (t, n), v in sorted_ms.items()},
    }, {
        "name": "trace_step (K3, split trace)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3663 trace_step -> _trace_kernel :3241 "
                    "(+ _finalize_hits :3504)",
        "launches": launches["K3"],
        "max_abs_err": k3_err,
        "ms": it["k3"],
        "plain_ms": it["k3_twin"],
        "bound_ms": it["k3_bound"][0],
        "bound_by": it["k3_bound"][1],
        "library_ms": None,
        "bound_ms_cluster_floor": it["k3_bound_brute"][0],
        "walk_work": it["work"],
        "ms_cornell_textured": ct["k3"],
        "plain_ms_cornell_textured": ct["k3_twin"],
        "bound_ms_cornell_textured": ct["k3_bound"][0],
        "bound_ms_brute_force_cornell_textured": ct["k3_bound_brute"][0],
        "ms_bounce2_coherence_order": split_times["interior_bounce2"]["k3"],
        "ms_bounce2_unsorted": split_times["interior_bounce2"]["k3_unsorted"],
        "bound_ms_bounce2": split_times["interior_bounce2"]["k3_bound"][0],
        "bound_ms_cluster_floor_bounce2": split_times["interior_bounce2"]["k3_floor"][0],
        "walk_work_bounce2": split_times["interior_bounce2"]["work"],
        "max_abs_err_peel": peel_errs["k3"],
        "ms_peel_clipped": {k: v["k3"] for k, v in peel.items() if k.startswith("clip_")},
        "ms_retrace_masked": {k: v["ms"] for k, v in peel.items() if k.startswith("retrace")},
        "bound_ms_retrace_masked": {k: v["bound"][0] for k, v in peel.items()
                                    if k.startswith("retrace")},
        "launches_by_new_frame": {k: v["K3"] for k, v in new_launches.items()},
        "content": content_entry(content, "K3"),
        "formats": formats_entry(formats, "K3"),
        "formats2": formats_entry(formats2, "K3"),
        "webp": formats_entry(webp_out, "K3"),
        "jpeg2000": formats_entry(j2k_out, "K3"),
        "tiff": formats_entry(tiff_out, "K3"),
        "legacy": formats_entry(legacy_out, "K3"),
    }, {
        "name": "shade_step (K4, split shade)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/ops/pallas_bounce.py:3705 shade_step -> _shade_kernel :3370",
        "launches": launches["K4"],
        "max_abs_err": k4_err,
        "ms": it["k4"],
        "plain_ms": it["k4_twin"],
        "bound_ms": it["k4_bound"][0],
        "bound_by": it["k4_bound"][1],
        "library_ms": None,
        "texture_stage_ms": it["stage"],
        "bound_ms_pr3_9_floor": it["k4_floor"][0],
        "shadow_walk_work": it["k4_work"],
        "distinct_texel_rows": it["k4_texels"],
        "ms_nee_off": it["k4_nee_off"],
        "ms_bounce2": split_times["interior_bounce2"]["k4"],
        "bound_ms_bounce2": split_times["interior_bounce2"]["k4_bound"][0],
        "ms_interior_taps": split_times["interior_taps"]["k4"],
        "texture_stage_ms_interior_taps": split_times["interior_taps"]["stage"],
        "bound_ms_interior_taps": split_times["interior_taps"]["k4_bound"][0],
        "ms_cornell_textured": ct["k4"],
        "plain_ms_cornell_textured": ct["k4_twin"],
        "texture_stage_ms_cornell_textured": ct["stage"],
        "bound_ms_cornell_textured": ct["k4_bound"][0],
        "max_abs_err_peel": peel_errs["k4"],
        "ms_peel_clipped": {k: v["k4"] for k, v in peel.items() if k.startswith("clip_")},
        "launches_by_new_frame": {k: v["K4"] for k, v in new_launches.items()},
        "content": content_entry(content, "K4"),
        "formats": formats_entry(formats, "K4"),
        "formats2": formats_entry(formats2, "K4"),
        "webp": formats_entry(webp_out, "K4"),
        "jpeg2000": formats_entry(j2k_out, "K4"),
        "tiff": formats_entry(tiff_out, "K4"),
        "legacy": formats_entry(legacy_out, "K4"),
    }, {
        "name": "tap_rows (K4t, K4's taps alone: the first-hit AOVs' material and the "
                "textured cutout's opacity)",
        "route": "cuda",
        "source": "gatling_tpu_torch/csrc/bounce.cu",
        "replaces": "gatling_tpu/render/fused.py:241 _material_rows (the texture stage before "
                    "gatling_tpu/ops/pallas_bounce.py:3705 shade_step) at the bounce-0 peel "
                    ":481-490 and the textured-cutout re-trace :326-333",
        "launches": new_launches["cornell_first_hit"]["K4t"],
        "max_abs_err": peel_errs["taps"],
        "ms": taps["ms"],
        "plain_ms": taps["plain_ms"],
        "bound_ms": taps["bound"][0],
        "bound_by": taps["bound"][1],
        "library_ms": None,
        "by_wave": {k: {f: v[f] for f in ("rays", "hit_rays", "ms", "plain_ms",
                                           "distinct_texel_rows", "opacity")}
                    | {"bound_ms": v["bound"][0]}
                    for k, v in peel.items() if "ms" in v and "alive" not in v},
        "launches_by_new_frame": {k: v["K4t"] for k, v in new_launches.items()},
    }, *(trace_entry(k, trace_times, launches[k]) for k in ("K5", "K6", "K7", "K8")),
        *(threaded_entry(k, threaded_times, threaded_launches, threaded_frames, formats)
          for k in ("B1", "B2")),
        *branch_entries(branch, lobe_launches),
        *branch_entries(vol_branch, vol_launches, VOLUME_BRANCHES),
        *flt_entries(hdr_branch, hdr_tap_times, hdr_tap_errs, dome_launches, formats, formats2,
                     j2k_out, tiff_out, legacy_out),
        *probe_entries(probe_launches, p1, p2, p2_library, stream_us)]}))
    # the run drives one card (cuda:0), whatever the host holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
