"""Smoke run of the PyTorch/CUDA port (eioku_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line) on error:

1. environment: the card's name and power limit, torch and CUDA versions;
   builds every kernel of the path from csrc/ (one nvcc per source, started
   together) and prints the build time and ptxas' resource report; counts
   the HGMMA (wgmma) and UTMALDG (TMA load) instructions in K3's library
   (cuobjdump --dump-sass) and fails if either is 0, or if ptxas reports a
   spill in K3's bf16 and f16 kernels, in K2's two kernels (mask and
   scan) or in K4's or K5's;
2. K1 scene-diff kernel against its plain PyTorch version on the card, at the
   main path's chain shape [257, 46080] and a ragged one (odd N, D not a
   multiple of 4): max abs error <= 1e-6, then kernel / plain / library time
   over four main-path chains cycled, so that L2 never holds the next input,
   and the kernel's time replayed from a CUDA graph over the same chains
   (device time without the wrapper's host cost);
3. K2 NMS keep-mask kernel against its plain version at B = 64,
   K in {256, 300, 512, 1024} with padding tails: keep masks exactly equal;
   times over back-to-back calls at every K and, at K = 256 and 1024, also
   replayed from a CUDA graph (the gap is the wrapper's host cost), beside
   the launch floor: an empty kernel's graph-replayed time;
3b. K3 flash-attention kernel against its plain version at the Whisper
   large-v3 encoder's [4, 20, 1500, 64] in bf16, f16 and f32, causal
   [2, 4, 200, 64] f32, MiniLM's [2, 12, 512, 32] bf16 and f16 with lengths
   [512, 130], and rows of length 0 (zeros, no NaN). fp32: 2e-5 absolute;
   bf16: 1 bf16 ulp of the plain version (fp32 from the same bf16 inputs,
   rounded once) plus 2^-8 * sum_j p_j |v_j|, since the kernel rounds P to
   bf16 once before P V (csrc/flash_attention.cu); f16: 1 f16 ulp plus
   2^-11 * sum_j p_j |v_j|. Then kernel / plain /
   bound / scaled_dot_product_attention times at the encoder's shape, and
   kernel / bound / scaled_dot_product_attention (with a key mask) at
   MiniLM's, there both over back-to-back calls and replayed from a CUDA
   graph (device time without the host's), each with the kernel's share of
   its bound and its ratio to the library time; the f16 route likewise at
   both shapes, beside scaled_dot_product_attention in f16;
3c. K4, the decode attention kernel (csrc/decode_attention.cu), against its
   plain version at large-v3's batched decode (40 rows: self over 256
   positions at pos 0, 3, 63, 127, 255; cross over 8 windows x 1500 frames,
   5 beams a window) and the conditioned decode's (5 rows, self over 448,
   cross over one window), in bf16, f16 and fp32: bf16 within 1 ulp plus
   2^-8 * sum_j p_j |v_j|, f16 1 ulp plus 2^-11 * sum_j p_j |v_j|, fp32 2e-5;
   the cache past pos poisoned with NaN gives the same output; one graph
   replayed at three positions equals each eager call. Then kernel / plain /
   bound / scaled_dot_product_attention times at the cell's cross and self
   (pos 127) shapes, calls and graph;
3d. K5, the add-and-LayerNorm kernel (csrc/add_layer_norm.cu), against its
   plain version at rows 1, 7, 40 and 64 and widths 384-1280, the
   LayerNorm alone, after a product and after its bias, in bf16, f16 and
   fp32: the residual bit for bit, h within one ulp of the normalised value
   at the row's scale (four in fp32) carried through gamma and beta, 16-bit
   h at least 99% bit for bit; one graph replayed equals its eager call. Then kernel /
   plain / `F.layer_norm` times at the cell's [40, 1, 1280] and at 384,
   calls and graph, beside the bound and the launch floor;
4. the visual pass: InferenceEngine(device="cuda").run_task("visual_analysis")
   with all four sub-tasks at their defaults -- scenes, YOLOv8n objects,
   yolov8n-face faces (threshold FACE_CONF, embeddings on: ArcFace
   iresnet18) and ResNet18-Places365 places (top 5) -- at full published
   widths (random weights from seed 0; detectors and ResNet18 in bf16,
   ArcFace in fp32) over a 60 s 1280x720 30 fps clip with planted colour
   cuts. With scenes at 4 fps the base step is 8 frames: objects and places
   land on step 32 (places fuse into the object upload), faces on step 88,
   which 32 does not divide, so faces take their own consumer. The launch
   counts are zeroed just before the measured run and read just after; K1
   and K2 must have launched, K2 once per detect batch (objects + faces).
   The candidates that run hands to the NMS (YOLOv8n's top 256 at 80
   classes; yolov8n-face's top 256 at one class) are kept, and the kernel's
   keep masks on them must equal the plain version's exactly; so on the
   top_k = 1024 run below. The scene count must equal the cuts + 1, object
   and face rows must be finite, face rows more than 0, embeddings unit
   norm, place rows one per object-grid frame with 5 predictions each, and
   the scene rows must equal those of the port's CPU path on the same clip.
   A second run takes the fully fused route (faces every 96 frames ride the
   object upload as a device-side gather). face_detection and
   place_classification run as tasks of their own. YOLOv8n, ResNet18 and
   ArcFace fp32 outputs on the card (TF32 off) must agree with the CPU's on
   a small batch. A run of the object_detection task takes top_k = 1024
   (the K > max_det NMS route);
4b. transcription at full width: a 150 s 16 kHz wav of five 30 s windows,
   window 2 digitally silent (the energy VAD drops it: 4 windows, one
   batch), through run_task("transcription") with Whisper large-v3 (random
   weights from seed 0, bf16), batch 4, 224 tokens: a warm-up, then a
   measured run whose K3 launches must be 32 x its encoder calls and whose
   result must be [] (random weights emit no rows, as in the JAX package);
   then the same at compute_dtype float16 (K3's f16 route, 32 launches per
   encoder call; one f16 encoder output must be finite): wall, audio-s/s;
4c. production decode at full width: whisper_decode_windows, beam 5, 224
   tokens with EOT suppressed, on the encoder output of those 4 windows;
4d. card against CPU on the pretrained path: a random tiny tree (seed 0)
   saved as whisper-tiny.npz in OpenAI naming, transcribed on the card (TF32
   off) and on the CPU in fp32 with beam 5 and timestamps: encoder states
   within 1e-3 and rows equal (where tokens first differ, the CPU's top-2
   log-prob margin there must be below 1e-3); once more with the
   temperature ladder on;
4e. the host stack: a fresh SQLite database and the port's AppConfig
   (combined_visual, the four visual sub-tasks at VISUAL_CONFIG, ocr and
   metadata_extraction active, visual_search and semantic_search on) over a
   folder holding the 60 s clip: discovery folds ocr into visual_analysis.
   create_app's start-up hook (the API's: scan-path merge, discovery),
   workers.main's build_worker with the engine on the card and max_jobs 1,
   then Worker.drain. Launch counts are zeroed just
   before the drain and read just after: K1 once, K2 twice. Both tasks and
   the visual task's two follow-ups (semantic_indexing, visual_indexing)
   must end COMPLETED; the database's artifacts of each sub type, OCR's
   included, in order, must equal the rows built from what the engine
   returned inside the worker; scene rows equal the CPU path's (phase 4);
   scene_ranges, object_labels and face_clusters agree with the artifacts;
   the video's duration is set from its metadata; jump finds the 20 s cut
   from 15 s. Every OCR row is in ocr_fts and find returns a hit for a word
   of them; semantic_indexing indexed OCR chunks; visual_indexing embedded
   one keyframe per scene midpoint on the card, each read from the pass's
   keyframe cache (0 calls of _decode_at), and a visual search returns all
   of them. Then one ad-hoc transcription job on the wav (the tiny
   pretrained path of 4d) through the producer: K3 launches, its rows equal
   the engine's, find returns a hit for a word of them through FTS5. The
   semantic index (MiniLM-L6 from a written checkpoint, bf16 on the card)
   runs the transcription's semantic_indexing follow-up, which must end
   COMPLETED, with one embedding_chunks row per chunk of the engine's
   transcript rows (the task's default chunking), and a search on the last
   chunk's text must return the video first at that chunk's span. Each
   task's worker and engine walls are printed; their difference is the
   host stack's own cost (database writes and projection
   sync). The same job runs once more under EIOKU_PROFILE_DIR: its
   torch.profiler trace must hold the engine thread's aten ops and K3's
   kernels;
5. the semantic layer on the card (TF32 off for every fp32 comparison):
   5.1 MiniLM-L6 at full width on seeded ids [32, 256] with padded tails:
   fp32 card vs CPU within 1e-4 per entry, bf16 card vs fp32 CPU cosine
   >= 0.995 per embedding, no K3 launch; 5.2 the S >= 512 route at
   [8, 512] with lengths (512, 130, 1, ...): K3 exactly 6 launches per
   call (counts zeroed just before, read just after), the same
   tolerances against the CPU route (K3's plain version), ms per bf16
   call; 5.3 bench.py:790-855's corpus (11,000 segments of 10 words from
   30) as transcript.segment artifacts through SemanticIndex.index_video
   (chunk_chars 60, no overlap, no OCR; batch 256): chunks, wall, chunks/s
   and K3 launches (0); embed only at batch 256 x S 256 bf16 (bench.py:
   207-241) in chunks/s; the IVF index's build time, then the p50 of 30
   searches (top 10) on chunk texts, each of which must find its own
   chunk; 5.4 bench.py:1024-1043's clustered corpus at N = 10,000 and
   262,144 x 384 (normalised, f16 on the card): _topk_cosine p50, card vs
   CPU top-10 slots equal wherever the 10th score leads the 11th by more
   than 1e-3, IvfIndex.build seconds and padded block bytes at 262,144,
   IvfIndex.search p50 and recall@10 against the exact top 10 at the
   default n_probe; 5.5 a written cross-encoder checkpoint and vocab in
   a cache of their own: Reranker.available, a 64-candidate rerank whose
   bf16 card logits hold within 5e-2 of the CPU's fp32 (fp32 card within
   1e-4 x max |logit|), ms per rerank; 5.6 the phase's peak device
   memory;
6. OCR at full width (CRAFT and CRNN, random weights from seed 0, fp32):
   CRAFT on one 384x640 frame of the clip and CRNN at every bucket width
   (32 ... 512, half the crops padded with -1.0) card (TF32 off) vs CPU
   within MODEL_TOL of the largest |value|; the standalone ocr task on the
   clip (2 s grid: 30 frames) after a warm-up: wall, rows, host box
   extraction seconds (extract_quads timed apart) and quads, recognition
   seconds (recognize_crops timed apart), peak MiB;
   visual_analysis with all five sub-tasks at their defaults after a
   warm-up: wall, video-s/s, peak, rows, with launch counts zeroed just
   before and read just after: K1 once, K2 twice (OCR launches neither);
   then visual_analysis decoding at full size with scenes at 2 fps, so
   that its OCR consumer sees the task's frames (the same 2 s grid, the
   same INTER_AREA resize of the source frame; both decoded by cv2): its
   OCR rows must equal the standalone task's;
7. CLIP ViT-B/32 at full width (random weights from seed 0): both towers
   card (TF32 off) vs CPU within MODEL_TOL; VisualIndex.embed_frames over
   CLIP_FRAMES 720p frames at batch 16 (host preprocessing included) in
   frames/s, unit norms, and its halves: the host preprocessing alone and
   the image tower alone; the query embedding's p50 over N_QUERIES calls;
   VisualIndex.index_video on the clip (no scenes: 10 s stride keyframes,
   seek-decoded), search (every keyframe, highest score first) and similar
   (anchor excluded);
8. the audio slice, each number printed beside the card's name and power
   limit: 8.1 QuantLinear card vs CPU at turbo's widths (1280->1280,
   1280->5120, 5120->1280) and fp32 activations: w_q, the int8 activations
   and the int32 accumulators equal, outputs within 1e-6 of their largest
   |value|, then ms per call beside the bf16 Linear at 4 rows;
   transcription with large-v3-turbo at full width (random weights; int8,
   its default, then bf16; each loaded fresh, then measured) on the wav with
   the bounded decode (AUDIO_BOUND): wall, audio-s/s, peak MiB, weight MiB,
   K3 32 launches per encoder call; the semantic index with embed_int8 on
   phase 5's seeded MiniLM: embed-only chunks/s beside the bf16 index's (in
   turns), cosine >= 0.99 to the bf16 embeddings; 8.2 seeded bf16
   checkpoints (turbo; large-v3) with a vocab.json and merges.txt, written
   (timed apart) and deleted: word_timestamps and condition_on_previous_text
   on turbo (int8), draft_model on large-v3 drafted by turbo (one batch: K3
   64 launches, two encoders), each through run_task: walls, words per row,
   windows decoded serially, accept_rate; phase 4d also transcribes its tiny
   tree with each option on the card and on the CPU, rows equal; 8.3 a
   seeded Silero-v5-width VAD exported with the port's exporter (head
   VAD_HEAD): vad_probs card vs CPU at fp32 within 1e-5 at its init and
   within 8e-5 with the head scaled by 8, and the activity of
   split_windows on the wav through silero_vad.ckpt card vs CPU equal
   wherever the probabilities keep more than 1e-4 from 0.5; 8.4 ECAPA-TDNN
   at full published width (random, seed 0): fp32 card vs CPU within
   MODEL_TOL, bf16 cosine >= 0.99 to fp32; run_task("speaker_diarization")
   on the wav: windows, windows/s, turns, wall, peak MiB. Phase 4e also
   enqueues one speaker_diarization job, which the worker completes with
   speaker.turn rows equal to the engine's;
9. the serving path as a deployment runs it: `python -m
   eioku_tpu_torch.api.main` as its own process (no EIOKU_FORCE_CPU, so on
   the card) over phase 4e's database, vector files and keyframe cache,
   with a config of phase 4e's tasks and a model cache holding 4e's MiniLM
   and phase 5's seeded cross-encoder with its vocab.txt; seconds to its
   first 200 on /health; /api/v1/device must name the card (backend cuda,
   platform gpu). 9.2 every route against the database, over a localhost
   socket (urllib): /videos, the clip's artifacts of five types, jump
   (object, face, scene), find (an OCR word, a transcript word), subtitles
   (vtt, srt, with speakers), /people, each equal to what this process
   reads from the same database; the thumbnail cold then cached (equal
   bytes), a 5 s /clip (the cv2 re-encode: frames), /stream with a Range
   (206, the file's bytes), /tasks, /stats, /metrics, /openapi.json, the
   SPA. 9.3 search on the card: the first semantic request (MiniLM loads
   in the API process) timed apart, then p50 and p95 over API_REQUESTS
   requests of each mode (semantic, keyword, hybrid, visual, semantic with
   rerank, /similar); the semantic and visual hits equal SemanticIndex's
   and VisualIndex's in this process on the same files (order, and scores
   within 2e-2), whose search calls are timed alone beside them (the
   difference is HTTP, JSON and the loop), and rerank answers reranked. 9.4 /health alone and among
   API_CONCURRENT concurrent semantic searches. 9.5 PUT a second clip
   (other colours and cuts) to /videos/upload, drain the queue with the
   port's worker in this process on the same database and card while the
   API process runs, with the launch counts zeroed just before the drain
   and read just after (K1 once, K2 twice), then poll the API until the new
   video answers visual search (one hit per keyframe) and jump (its first
   cut): the wall from upload to visually searchable, split into the PUT,
   the engine, the host stack, the follow-ups and the first search after
   the append. 9.6 the ops CLI as processes on the card: `search` agrees
   with the API's semantic hits; `stats`, `people`, `export-dump`, then
   `import-dump` into a fresh database with the exported row counts. 9.7
   each process's device memory (nvidia-smi's memory.used before the API
   starts and after its warm-up, less this process's allocator growth).
   The server is stopped at the
   end of the phase, and killed if it fails;
10. detection's options on the 60 s clip (TF32 off): 10.1 the device
   letterbox (ops/resize.py) of one 64-frame batch, card against CPU within
   LETTERBOX_TOL, within one uint8 level of cv2's host letterbox, and fp32
   YOLOv8n rows from both letterboxes on the same frames (matched share
   reported); the
   object_detection task with preprocess "device" beside the host route;
   10.2 object_detection and face_detection with int8 beside bf16 (wall,
   peak MiB) and visual_analysis with int8 objects and faces (K1, K2
   launched); 10.3 the int8 conv with the most weights on its main-path
   input: int8 activations, scales and int32 sums card == CPU, ms beside
   the bf16 conv; 10.4 object_detection with data_parallel true on the one
   card (rows equal the plain task's) and a DataParallelDetector over
   [cuda:0, cuda:0] (two K2 launches, outputs equal to the plain detect on
   each share at fp32; rows against the whole batch at once reported);
11. `python -m eioku_tpu_torch.cli finetune` as a process over phase 5's
   database of indexed chunks and its seeded MiniLM: 20 steps at batch 16,
   the first step's loss within FINETUNE_LOSS_RTOL of the same batch on the
   CPU (fp32, TF32 off), the loss falling, the saved native.npz loaded by
   load_minilm; ms per step timed in this process;
12. the multi-device serving layer, every mesh on the one card (its shards
   run one after the other, so no time here is a speed-up): 12.1 a process
   joins a world-size-1 NCCL group from EIOKU_COORDINATOR /
   EIOKU_NUM_PROCESSES / EIOKU_PROCESS_ID (initialize_distributed), runs an
   all_reduce and the port's collectives, init seconds reported; 12.2 K3
   at the TP encoder's local heads (H = 10 and 5, as [B, S, H, D] views of
   the column shard, which must not be copied) in bf16 and f16 against its
   plain version and timed; the TP encoder at large-v3 over [cuda:0] * 2
   and * 4 on the 4 voiced windows against whisper_encode: bf16 within
   TP_BF16_FACTOR times bf16's own departure from fp32 on the same
   weights, fp32 (TF32 off) within 1e-4 of the largest |value|, K3 32 x tp
   launches; 12.3 the large-v3 bf16 TP decode (beam 5) against one device:
   the tokens' agreement and the one-device top-2 margin where they first
   part, walls, device operations a step; then run_task("transcription")
   with tensor_parallel 2 on 4d's seeded tiny checkpoint, `local_devices`
   replaced by [cuda:0, cuda:0], rows equal to the one-device task at fp32;
   12.4 the PP encoder (2 stages of 16 layers, 2 microbatches) under 12.2's
   rule, K3 64 launches; 12.5 ring attention [1, 20, 6000, 64] fp32 over
   [cuda:0] * 4 within 2e-5 of full attention, and the MoE (d 1280, ffn
   5120, 8 experts, 4096 tokens) over [cuda:0, cuda:0] within 1e-4 of one
   device, each timed;
13. JSON lines: each slice's results, phase 5's to 12's, each phase's
   seconds, and {"kernels": [...]} with each kernel's launches in the
   measured run, max error, kernel / plain / bound / library times (K1's
   and K2's entries also with their launches in the pass with OCR, through
   the worker, in phase 9's upload drain and in the int8 pass, K2's with
   two replicas; K3's with its launches per MiniLM call at S = 512, on the
   indexing path, in turbo's int8 and bf16 runs, in a speculative batch
   and in the f16 transcription, on the TP and PP encoders and in the TP
   transcription, and its f16 route's error and times, and at H = 10 and 5);
14. the card's name and power limit (nvidia-smi), then, as the last line,
   {"ok": true, "device": {...}}.

Without CUDA, or outside a checkout of the repository, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
K1_SHAPE = (257, 96 * 160 * 3)  # SCENE_CHUNK + 1 carried plane, D = 96*160*3
K1_RAGGED = (67, 1001)
K1_TIMING_CHAINS = 4
K2_BATCH = 64
K2_KS = (256, 300, 512, 1024)
K2_MAIN_K = 256  # detect()'s default top_k
K2_BIG_K = 1024  # object_detection with top_k = 1024 (the K > max_det route)
CLIP_W, CLIP_H, CLIP_FPS, CLIP_SECONDS = 1280, 720, 30, 60
CUT_EVERY_S = 10  # 6 colour segments -> 5 planted cuts
VISUAL_KERNELS = ("scene_diff", "nms")  # K1, K2: the visual pass's kernels
# random yolov8n-face weights score every anchor near 0.5: at the default
# 0.7 no face row appears, at 0.2 every anchor is a candidate (the dense
# one-class case of K2)
FACE_CONF = 0.2
VISUAL_CONFIG = {"scene_detection": {}, "object_detection": {"batch_size": 64},
                 "face_detection": {"embeddings": True, "confidence_threshold": FACE_CONF},
                 "place_classification": {}}
# faces every 3.2 s: step 96 at 30 fps, a multiple of the object step 32
FUSED_CONFIG = {**VISUAL_CONFIG, "face_detection": {
    **VISUAL_CONFIG["face_detection"], "frame_interval_s": 3.2}}
# embeddings are rounded to 5 places: each of 512 entries moves up to 5e-6,
# so the norm of a unit vector moves up to sqrt(512) * 5e-6
EMBED_NORM_TOL = 512 ** 0.5 * 5e-6
MODEL_TOL = 1e-4  # fp32 card (TF32 off) vs CPU, relative to the largest |value|
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
K3_SHAPE = (4, 20, 1500, 64)  # Whisper large-v3 encoder, batch 4
K3_MINILM = ((2, 12, 512, 32), (512, 130))  # MiniLM's route: shape, lengths
K3_CASES = (  # shape, dtype name, causal, lengths
    (K3_SHAPE, "bfloat16", False, None),
    (K3_SHAPE, "float16", False, None),
    ((2, 12, 512, 32), "float16", False, (512, 130)),
    ((2, 2, 130, 64), "float16", True, (0, 100)),
    (K3_SHAPE, "float32", False, None),
    ((2, 4, 200, 64), "float32", True, None),
    ((2, 12, 512, 32), "bfloat16", False, (512, 130)),
    ((2, 2, 77, 32), "float32", False, (0, 77)),
    ((2, 2, 130, 64), "bfloat16", True, (0, 100)),
)
# K4, the decode attention kernel, at large-v3's batched decode: 8 windows x 5
# beams (40 query rows) of 20 heads x 64; the self cache of 256 positions
# (timed at position 127), the encoder's 1500 frames a window
K4_HEADS, K4_WIDTH, K4_ROWS, K4_WINDOWS, K4_CACHE, K4_POS = 20, 1280, 40, 8, 256, 127
K4_CASES = (  # query rows, K/V rows, frames, positions (None: all frames live)
    (K4_ROWS, K4_ROWS, K4_CACHE, (0, 3, 63, 127, 255)),  # self, the cell's decode
    (K4_ROWS, K4_WINDOWS, 1500, None),  # cross, 5 beams a window
    (5, 5, 448, (130, 447)),  # the conditioned decode's self
    (5, 1, 1500, None),  # and its cross
)
# K5, the add-and-LayerNorm kernel: the cell's step (40 beam rows of one
# position at large-v3's 1280) and tiny's 384, timed; checked at every Whisper
# width and 1-64 rows
K5_ROWS, K5_WIDTHS, K5_TIMED = 40, (384, 512, 768, 1024, 1280), (1280, 384)
K5_MODES = ("ln", "y", "y+b")  # the LayerNorm alone; after a product; after its bias too
K5_EPS = 1e-5
AUDIO_SECONDS, SILENT_WINDOW = 150, 2  # five 30 s windows, window 2 silent
SAMPLES_PER_WINDOW = 30 * 16000
WHISPER_CONFIG = {"model": "large-v3", "random_full_size": True,
                  "batch_size": 4, "max_tokens": 224}
TINY_CONFIG = {"model": "tiny", "language": "en", "compute_dtype": "float32",
               "temperatures": [], "max_tokens": 32, "no_speech_threshold": 2.0}
TINY_OPTIONS = {  # 4d's options, card against CPU
    "word_timestamps": {"word_timestamps": True},
    "condition_on_previous_text": {"condition_on_previous_text": True},
    "draft_model": {"draft_model": "tiny", "beam_size": 1, "timestamps": False},
}
TOKEN_MARGIN_TOL = 1e-3  # CPU top-2 log-prob gap where card and CPU part
ENC_TOL = 1e-3  # tiny encoder, fp32 card (TF32 off) vs CPU
# phase 5, the semantic layer: MiniLM-L6 and the cross-encoder at full width
MINILM_CHECK = (32, 256)  # card vs CPU at the indexing path's S
MINILM_LONG = (8, 512)  # the S >= 512 route through K3, with these lengths:
MINILM_LONG_LENGTHS = (512, 130, 1, 300, 512, 64, 257, 400)
MINILM_TOL = 1e-4  # fp32 card (TF32 off) vs CPU, per entry of unit vectors
MINILM_COS = 0.995  # bf16 card vs fp32 CPU: cosine per embedding
RERANK_TOL = 5e-2  # rerank logits, bf16 card vs fp32 CPU (they spread over ~2)
# bench.py:790-855's search corpus: 11,000 segments of 10 words from 30
SEM_SEGMENTS = 11000
SEM_WORDS = ("meeting beach sunset dog cat birthday cake garden hiking snow city car "
             "bridge concert guitar kitchen recipe soccer goal lake boat camera "
             "interview presentation whiteboard laptop coffee airport train museum "
             "painting").split()
EMBED_BATCH, EMBED_SEQ, EMBED_BATCHES = 256, 256, 10  # bench.py:207-241
RETRIEVAL_SIZES = (10_000, 262_144)  # bench.py:1046's N, and 192 MiB of f16
N_QUERIES = 30
GAP_TOL = 1e-3  # card vs CPU top-10 compared where the 10th score leads the 11th by more
CLIP_FRAMES = 128  # embed_frames' measured batch of frames
# phase 8, the audio slice
INT8_WIDTHS = ((1280, 1280), (1280, 5120), (5120, 1280))  # turbo's linears (in, out)
INT8_ROWS = (4, 1500)  # a greedy decode step of 4 windows; one window's encoder rows
INT8_TOL = 1e-6  # QuantLinear card vs CPU, relative to the largest |value|
AUDIO_BOUND = {"temperatures": [], "max_tokens": 32, "batch_size": 4}  # the bounded decode
TURBO_CONFIG = {"model": "large-v3-turbo", "random_full_size": True, **AUDIO_BOUND}
# the options on seeded checkpoints: random weights emit rows; never gate them
OPTION_CONFIG = {"language": "en", "no_speech_threshold": 2.0, **AUDIO_BOUND}
EMBED_INT8_COS = 0.99  # int8 vs bf16 MiniLM embeddings on the card
VAD_HEAD = (8.0, -3.0)  # output weight scale and bias: passes the loader's check
# vad_probs fp32 card (TF32 off) vs CPU over the wav's 4,688 chunks: at the
# model's init; times VAD_HEAD's scale with the checkpoint's scaled head
VAD_TOL = 1e-5
VAD_MARGIN = 1e-4  # activity compared where the probability keeps this far from 0.5
ECAPA_WINDOWS = 32  # one diarization batch of 1.5 s windows
ECAPA_COS = 0.99  # ECAPA bf16 vs fp32 embeddings on the card
# phase 10, detection's options
LETTERBOX_TOL = 1e-5  # device letterbox fp32 card (TF32 off) vs CPU, values in [0, 1]
LETTERBOX_CPU_FRAMES = 8  # frames letterboxed on the CPU for that check
# phase 11, the fine-tune
FINETUNE_STEPS, FINETUNE_BATCH = 20, 16
FINETUNE_LOSS_RTOL = 1e-4  # the first step's loss, card (TF32 off) vs CPU, fp32
# phase 12, the multi-device serving layer, its shards on one card listed
# several times (NCCL takes one rank a card, and the smoke run has one card)
TP_SIZES = (2, 4)  # large-v3's 20 heads: 10 and 5 a shard
TP_FP32_TOL = 1e-4  # fp32 TP and PP encoders vs one device (TF32 off), relative
# bf16 TP and PP encoders vs the bf16 one-device encoder, relative to the
# largest |value|: at most this multiple of bf16's own departure from fp32 on
# the same weights (the sharded encoders round where one device rounds, and
# once more per residual sum; both departures grow alike through 32 layers)
TP_BF16_FACTOR = 2.0
PP_MICRO = 2  # large-v3's 32 encoder layers over 2 stages: 16 a stage
TP_DECODE_LEN = 64  # large-v3 bf16 TP decode, beam 5, EOT suppressed
RING_SHAPE = (1, 20, 6000, 64)  # 4 x 1500 frames: two minutes as one context
RING_TOL = 2e-5
MOE_SHAPE = (1280, 5120, 8, 4096)  # d, ffn, experts, tokens
MOE_RTOL = 1e-4
# phase 13, training over several devices, every mesh on the one card
TRAIN_LR = 1e-3  # a step of the wrong sign moves a parameter 2e-3, past TRAIN_ATOL
TRAIN_STEPS = 2
TRAIN_LOSS_RTOL = 1e-5  # the first loss, sharded vs one device (fp32, TF32 off)
# the first step's gradient, sharded vs one device, relative to its leaf's
# largest |value| (AdamW's steps hide a gradient's scale: this holds it)
TRAIN_GRAD_RTOL = 1e-4
# parameters after TRAIN_STEPS: the JAX package's FSDP tolerance
# (tests/test_parallel.py TestFsdp); an element whose gradient is within
# TRAIN_GRAD_RTOL of zero (the key biases: zero in exact arithmetic) has no
# sign to hold, AdamW steps it by about lr either way: the step bound
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
TRAIN_STEP_BOUND = 2 * TRAIN_LR * TRAIN_STEPS * 1.01
TRAIN_TIMED = 3  # steps timed per mesh, after the gated ones
FSDP_ENTRIES = 4
PG_STEPS = 3  # cli finetune over the world-size-1 group
PG_LOSS_RTOL = 1e-6  # its first loss against phase 11's (the same batch and code)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5, args=((),)) -> float:
    """Mean device time of fn(*a) over `iters` back-to-back calls (CUDA
    events), cycling through the argument tuples in `args`: inputs larger
    than the 50 MB L2 together make every call read device memory."""
    import torch

    for i in range(warmup):
        fn(*args[i % len(args)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args[i % len(args)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _spills(ptxas_log: str, entries: tuple[str, ...]) -> list[str]:
    """ptxas' spill lines for the kernels named in `entries` that spill."""
    bad, watched = [], False
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            watched = any(e in line for e in entries)
        elif watched and "spill stores" in line:
            stores, loads = (int(x) for x in re.findall(r"(\d+) bytes spill", line))
            if stores or loads:
                bad.append(line.strip())
    return bad


def cuda_graph_ms(fn, args, iters: int = 20, replays: int = 10) -> float:
    """Mean device time of fn(*a) with the host taken out: `iters` calls,
    cycling through `args`, captured once in a CUDA graph and replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for a in args:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(*args[i % len(args)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def phase_build() -> dict:
    from eioku_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()  # every source is stale in a fresh checkout
    each = ", ".join("%s %.2f s" % (n, b["seconds"]) for n, b in built.items())
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall ({each or 'up to date'})")
    for name, b in built.items():
        for line in b["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line) \
                    or "spill stores" in line:
                log(f"  {name}: {line.strip()}")
    for name in _cuda.KERNELS:
        _cuda.load(name)
    for name, label, entries in (
            ("flash_attention", "K3's bf16 and f16 kernels", ("flash_hopper",)),
            ("nms", "K2's kernels", ("nms_mask_kernel", "nms_scan_kernel")),
            ("decode_attention", "K4's kernels", ("decode_attention_kernel",)),
            ("add_layer_norm", "K5's kernels", ("add_layer_norm_kernel",))):
        if name not in built:
            log(f"{label} were built before this run: their ptxas report is not checked")
            continue
        spills = _spills(built[name]["log"], entries)
        if spills:
            raise AssertionError(f"{label} spill: {spills}")
        log(f"{label}: no spills in ptxas' report")
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", _cuda._lib_path("flash_attention")],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
    log(f"K3 SASS: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG instructions")
    if not all(counts.values()):
        raise AssertionError(f"K3 has no wgmma or no TMA load in its SASS: {counts}")
    return built


def phase_k1(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.scene_diff import pair_diff, pair_diff_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {}
    for n, d in (K1_SHAPE, K1_RAGGED):
        chain = torch.rand((n, d), generator=gen, device=dev)
        got = pair_diff(chain)
        want = pair_diff_plain(chain)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        log(f"K1 scene_diff [{n}, {d}]: max abs err {err:.3e}")
        if not err <= 1e-6:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"[{n}, {d}]: {err}")
        if (n, d) != K1_SHAPE:
            continue
        # four chains (190 MB) cycled, so that no call finds its 47 MB chain
        # left in L2 by the call before
        chains = [(chain,)] + [(torch.rand((n, d), generator=gen, device=dev),)
                               for _ in range(K1_TIMING_CHAINS - 1)]
        ms = cuda_ms(pair_diff, args=chains)
        graph_ms = cuda_graph_ms(pair_diff, args=chains)
        plain_ms = cuda_ms(pair_diff_plain, args=chains)
        library_ms = cuda_ms(
            lambda c: F.pairwise_distance(c[:-1], c[1:], p=1.0, eps=0.0),
            args=chains)
        nbytes = n * d * 4 + (n - 1) * 4
        ops = 3 * (n - 1) * d  # sub, abs, add per element pair
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        result = {"max_abs_err": err, "ms": ms, "cuda_graph_ms": graph_ms,
                  "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "library_ms": library_ms}
        log(f"K1 [{n}, {d}]: kernel {ms:.5f} ms (calls), {graph_ms:.5f} ms (graph; "
            f"{result['bound_ms'] / graph_ms:.1%} of the bound), plain {plain_ms:.4f} ms, "
            f"pairwise_distance {library_ms:.4f} ms, bound {result['bound_ms']:.5f} ms "
            f"({nbytes / 1e6:.1f} MB)")
    return result


def _nms_workload(b: int, k: int, seed: int, pad_from: int, n_classes: int = 3):
    """Score-sorted candidates as in tests/test_nms_kernel.py, with a tail of
    zero-score padding."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (b, k, 2))
    wh = rng.uniform(5, 40, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.1, 1.0, (b, k)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    scores[:, pad_from:] = 0.0
    classes = rng.integers(0, n_classes, (b, k)).astype(np.int32)
    return boxes, scores, classes


def _nms_pair_ops(keep: np.ndarray, scores: np.ndarray,
                  classes: np.ndarray) -> int:
    """IoU tests the greedy order needs on this data: for each kept i, the
    valid same-class j > i (about 14 fp32 operations each)."""
    total = 0
    for b in range(keep.shape[0]):
        valid = scores[b] > 0
        for i in np.nonzero(keep[b])[0]:
            total += int(np.count_nonzero(valid[i + 1:]
                                          & (classes[b, i + 1:] == classes[b, i])))
    return 14 * total


def launch_floor_ms() -> float:
    """Graph-replayed time of one empty kernel: the least a launch costs."""
    import torch

    from eioku_tpu_torch.ops import _cuda

    lib = _cuda.load("nms")

    def empty():
        if lib.eioku_empty_launch(torch.cuda.current_stream().cuda_stream):
            raise AssertionError("the empty kernel did not launch")
    return cuda_graph_ms(empty, args=((),))


def phase_k2(dev) -> dict:
    import torch

    from eioku_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain

    floor_ms = launch_floor_ms()
    log(f"launch floor: an empty kernel replayed from a CUDA graph takes "
        f"{floor_ms:.5f} ms (K2 launches two kernels a call)")
    result = {"launch_floor_ms": floor_ms}
    for k in K2_KS:
        bx, sc, cl = _nms_workload(K2_BATCH, k, seed=k, pad_from=k - k // 5)
        boxes = torch.from_numpy(bx).to(dev)
        scores = torch.from_numpy(sc).to(dev)
        classes = torch.from_numpy(cl).to(dev)
        got = nms_keep_mask(boxes, scores, classes, 0.45)
        want = nms_keep_mask_plain(boxes, scores, classes, 0.45)
        mismatches = int((got != want).sum())
        kept = int(want.sum())
        log(f"K2 nms [B={K2_BATCH}, K={k}]: {kept} kept, {mismatches} mismatches")
        if mismatches:
            raise AssertionError(f"K2 keep mask differs from its plain version "
                                 f"at K={k} in {mismatches} slots")
        kernel = lambda: nms_keep_mask(boxes, scores, classes, 0.45)  # noqa: E731
        ms = cuda_ms(kernel)
        graph_ms = cuda_graph_ms(kernel, args=((),)) if k in (K2_MAIN_K, K2_BIG_K) else None
        plain_ms = cuda_ms(lambda: nms_keep_mask_plain(boxes, scores, classes, 0.45),
                           iters=5, warmup=1)
        nbytes = K2_BATCH * k * (16 + 4 + 4 + 1)
        ops = _nms_pair_ops(want.cpu().numpy(), sc, cl)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        log(f"K2 [B={K2_BATCH}, K={k}]: kernel {ms:.5f} ms (calls)"
            + ("" if graph_ms is None else f", {graph_ms:.5f} ms (graph)")
            + f", plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms")
        if k == K2_MAIN_K:
            result.update({"max_abs_err": 0.0, "ms": ms, "cuda_graph_ms": graph_ms,
                           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                           "library_ms": None})
        elif k == K2_BIG_K:
            result.update({"ms_k1024": ms, "cuda_graph_ms_k1024": graph_ms})
    return result


def bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def f16_ulp(x):
    """Spacing of f16 values at |x| (11 significant bits; 2^-24 below 2^-14)."""
    import torch

    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -14)))
    return torch.exp2(e - 10)


def k3_error(got, want, cancel) -> float:
    """fp32: max abs error. bf16: the largest (error - 1 ulp - 2^-8 *
    sum_j p_j |v_j|) over elements, <= 0 when within tolerance; f16: the
    same with 1 f16 ulp and 2^-11 (P rounded to f16's 11 bits)."""
    import torch

    if got.dtype != want.dtype:
        raise AssertionError("kernel and plain version differ in type")
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float(diff.max())
    top = got.float().abs().maximum(want.float().abs())
    if got.dtype == torch.float16:
        return float((diff - f16_ulp(top) - 2.0 ** -11 * cancel).max())
    return float((diff - bf16_ulp(top) - 2.0 ** -8 * cancel).max())


def phase_k3(dev) -> dict:
    import torch

    from eioku_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    result = {}
    for shape, dtype_name, causal, lengths in K3_CASES:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(shape[2])
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                         device=dev)
        got = flash_attention(q, k, v, lengths=lens, causal=causal)
        want = flash_attention_plain(q, k, v, lengths=lens, causal=causal)
        cancel = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       lengths=lens, causal=causal)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K3 {shape} {dtype_name}: non-finite output")
        if lengths is not None and lengths[0] == 0 and bool(got[0].any()):
            raise AssertionError(f"K3 {shape}: a row with no valid key is not zero")
        err = k3_error(got, want, cancel)
        max_abs = float((got.float() - want.float()).abs().max())
        tol = 2e-5 if dtype == torch.float32 else 0.0
        bound = "2^-11" if dtype == torch.float16 else "2^-8"
        log(f"K3 flash_attention {list(shape)} {dtype_name} causal={causal} "
            f"lengths={lengths}: max abs err {max_abs:.3e}"
            + ("" if dtype == torch.float32 else f", excess over 1 ulp + {bound} "
               f"sum p|v| {err:.3e}"))
        if not err <= tol:
            raise AssertionError(f"K3 disagrees with its plain version at {shape} "
                                 f"{dtype_name}: {err}")
        if (shape, dtype_name) == (K3_SHAPE, "bfloat16"):
            result["max_abs_err"] = max_abs
        if (shape, dtype_name) == (K3_SHAPE, "float16"):
            result["f16"] = {"max_abs_err": max_abs, "excess_over_tolerance": err}
    result.update(k3_encoder_times(dev, torch.bfloat16))
    result["f16"].update(k3_encoder_times(dev, torch.float16))
    result["minilm"] = {"bf16": phase_k3_minilm(dev, torch.bfloat16),
                        "f16": phase_k3_minilm(dev, torch.float16)}
    return result


def k3_encoder_times(dev, dtype) -> dict:
    """K3 at the encoder's shape and layout in `dtype` (bf16 or f16): [B, S,
    H, D] projections viewed as [B, H, S, D], two input sets (2 x 46 MB)
    cycled past the L2. The kernel and scaled_dot_product_attention in the
    same type, back-to-back calls and replayed from a CUDA graph, and the
    plain version's calls. The bound is the same for both types: the dense
    f16 peak equals bf16's."""
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    b, h, s_len, d = K3_SHAPE
    gen = torch.Generator(device=dev).manual_seed(7)
    sets = [tuple(torch.randn((b, s_len, h, d), generator=gen, device=dev)
                  .to(dtype).transpose(1, 2) for _ in range(3))
            for _ in range(2)]
    library = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, scale=d ** -0.5)
    nbytes = 4 * b * h * s_len * d * 2  # q, k, v read once, o written once
    ops = 4 * b * h * s_len * s_len * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "plain_ms": cuda_ms(flash_attention_plain, iters=5, warmup=1, args=sets)}
    name = "bf16" if dtype == torch.bfloat16 else "f16"
    calls = lambda fn, args: cuda_ms(fn, iters=30, args=args)  # noqa: E731
    for how, timer in (("calls", calls), ("graph", cuda_graph_ms)):
        ms, library_ms = timer(flash_attention, args=sets), timer(library, args=sets)
        out.update({f"{how}_ms": ms, f"{how}_library_ms": library_ms})
        log(f"K3 {list(K3_SHAPE)} {name} ({how}): kernel {ms:.5f} ms, plain "
            f"{out['plain_ms']:.5f} ms, scaled_dot_product_attention {name} "
            f"{library_ms:.5f} ms, bound {out['bound_ms']:.5f} ms ({ops / 1e9:.1f} "
            f"GFLOP, {nbytes / 1e6:.1f} MB); {out['bound_ms'] / ms:.1%} of the bound, "
            f"{ms / library_ms:.3f}x the library time")
    out["ms"], out["library_ms"] = out["calls_ms"], out["calls_library_ms"]
    return out


def phase_k3_minilm(dev, dtype) -> dict:
    """K3 at MiniLM's route, [2, 12, 512, 32] in `dtype` (bf16 or f16) with
    lengths [512, 130], against scaled_dot_product_attention with the same
    key mask. The bound counts what these lengths need: keys and values up
    to each length."""
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.flash_attention import flash_attention

    (b, h, s_len, d), lengths = K3_MINILM
    gen = torch.Generator(device=dev).manual_seed(11)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mask = (torch.arange(s_len, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    sets = [tuple(torch.randn((b, h, s_len, d), generator=gen, device=dev)
                  .to(dtype) for _ in range(3)) for _ in range(4)]
    kernel = lambda q, k, v: flash_attention(q, k, v, lengths=lens)  # noqa: E731
    library = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, scale=d ** -0.5)
    keys = sum(lengths)
    ops = 4 * h * s_len * keys * d
    nbytes = 2 * (2 * b * h * s_len * d + 2 * h * keys * d)  # q, o; k, v to each length
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    # back-to-back calls (what an eager caller waits for; the host's share
    # shows at this size), then device time from a replayed CUDA graph
    name = "bf16" if dtype == torch.bfloat16 else "f16"
    out = {"bound_ms": bound_ms}
    for how, timer in (("calls", cuda_ms), ("graph", cuda_graph_ms)):
        ms, library_ms = timer(kernel, args=sets), timer(library, args=sets)
        out.update({f"{how}_ms": ms, f"{how}_library_ms": library_ms})
        log(f"K3 MiniLM {[b, h, s_len, d]} {name} lengths {list(lengths)} ({how}): kernel "
            f"{ms:.5f} ms, scaled_dot_product_attention (key mask) {library_ms:.5f} ms, "
            f"bound {bound_ms:.5f} ms ({ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); "
            f"{bound_ms / ms:.1%} of the bound, {ms / library_ms:.3f}x the library time")
    return out


def k4_error(got, want, weight) -> float:
    """fp32: max abs error less 2e-5. bf16: the largest (error - 1 ulp -
    2^-8 * sum_j p_j |v_j|), f16: the same with 1 f16 ulp and 2^-11; <= 0
    within tolerance (csrc/decode_attention.cu: the output's own rounding,
    and a p_j that rounds to its neighbour where its score sums in another
    order)."""
    import torch

    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float((diff - 2e-5).max())
    top = got.float().abs().maximum(want.float().abs())
    if got.dtype == torch.float16:
        return float((diff - f16_ulp(top) - 2.0 ** -11 * weight).max())
    return float((diff - bf16_ulp(top) - 2.0 ** -8 * weight).max())


def phase_k4(dev) -> dict:
    """K4, the decode attention kernel, against its plain version at the
    batched decode's and the conditioned decode's shapes in bf16, f16 and
    fp32 (K4_CASES), a cache tail poisoned with NaN past the position, one
    graph replayed at several positions; then times at the cell's shapes."""
    import torch

    from eioku_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(rows, kv_rows, frames, dtype):
        return (torch.randn((rows, 1, K4_WIDTH), generator=gen, device=dev).to(dtype),
                torch.randn((kv_rows, frames, K4_WIDTH), generator=gen, device=dev).to(dtype),
                torch.randn((kv_rows, frames, K4_WIDTH), generator=gen, device=dev).to(dtype))

    worst = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for rows, kv_rows, frames, positions in K4_CASES:
            q, k, v = inputs(rows, kv_rows, frames, dtype)
            for p in positions or (None,):
                pos = None if p is None else torch.tensor([p], device=dev)
                got = decode_attention(q, k, v, K4_HEADS, pos=pos)
                want = decode_attention_plain(q, k, v, K4_HEADS, pos=pos)
                weight = decode_attention_plain(q.float(), k.float(), v.float().abs(),
                                                K4_HEADS, pos=pos)
                err = k4_error(got, want, weight)
                if not (bool(torch.isfinite(got).all()) and err <= 0):
                    raise AssertionError(f"K4 {dtype} rows {rows} over {kv_rows} x {frames} "
                                         f"pos {p}: past the tolerance by {err}")
                key = str(dtype).removeprefix("torch.")
                worst[key] = max(worst.get(key, -1.0), err)
                if pos is not None:  # the tail past pos is never read
                    k2, v2 = k.clone(), v.clone()
                    k2[:, p + 1:], v2[:, p + 1:] = float("nan"), float("nan")
                    if not torch.equal(decode_attention(q, k2, v2, K4_HEADS, pos=pos), got):
                        raise AssertionError(f"K4 read past position {p}")
    log(f"K4 against its plain version: largest excess over the tolerance {worst}")
    q, k, v = inputs(K4_ROWS, K4_ROWS, K4_CACHE, torch.bfloat16)
    pos = torch.zeros(1, dtype=torch.long, device=dev)
    eager = {p: decode_attention(q, k, v, K4_HEADS, pos=torch.tensor([p], device=dev))
             for p in (0, 100, 255)}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, k, v, K4_HEADS, pos=pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, K4_HEADS, pos=pos)
    for p in (255, 0, 100):
        pos.fill_(p)
        graph.replay()
        if not torch.equal(out, eager[p]):
            raise AssertionError(f"K4's replay at position {p} differs from its eager call")
    return {"excess_over_tolerance": worst, **k4_times(dev)}


def k4_times(dev) -> dict:
    """K4 at the cell's shapes, bf16: cross-attention (8 windows x 1500
    frames, 5 beams a window) and self-attention (40 rows at position 127 of
    256), back-to-back calls and replayed from a CUDA graph, over three
    input sets cycled past the L2; the plain version's calls; and
    scaled_dot_product_attention as the library's yardstick (the beams as a
    window's 5 query positions; self over the live prefix), which the port
    never calls. The bound: K and V read once at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(9)
    hd = K4_WIDTH // K4_HEADS
    live = K4_POS + 1
    out = {}
    for name, kv_rows, frames, pos in (
            ("cross", K4_WINDOWS, 1500, None),
            ("self", K4_ROWS, K4_CACHE, torch.tensor([K4_POS], device=dev))):
        sets = [tuple(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                      for shape in ((K4_ROWS, 1, K4_WIDTH), (kv_rows, frames, K4_WIDTH),
                                    (kv_rows, frames, K4_WIDTH)))
                for _ in range(3)]
        group = K4_ROWS // kv_rows
        read = frames if pos is None else live

        def kernel(q, k, v, pos=pos):
            return decode_attention(q, k, v, K4_HEADS, pos=pos)

        def plain(q, k, v, pos=pos):
            return decode_attention_plain(q, k, v, K4_HEADS, pos=pos)

        def library(q, k, v, read=read, group=group, kv_rows=kv_rows):
            qh = q.view(kv_rows, group, K4_HEADS, hd).transpose(1, 2)
            kh = k[:, :read].view(kv_rows, read, K4_HEADS, hd).transpose(1, 2)
            vh = v[:, :read].view(kv_rows, read, K4_HEADS, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, kh, vh, scale=hd ** -0.5)
        nbytes = 2 * kv_rows * read * K4_WIDTH * 2  # K and V to the live frames, once
        r = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
             "plain_ms": cuda_ms(plain, iters=10, warmup=2, args=sets)}
        calls = lambda fn, args: cuda_ms(fn, iters=60, args=args)  # noqa: E731
        for how, timer in (("calls", calls), ("graph", cuda_graph_ms)):
            ms, library_ms = timer(kernel, args=sets), timer(library, args=sets)
            r.update({f"{how}_ms": ms, f"{how}_library_ms": library_ms})
            log(f"K4 {name} {K4_ROWS} rows over {kv_rows} x {read} frames bf16 ({how}): "
                f"kernel {ms:.5f} ms, plain {r['plain_ms']:.5f} ms, "
                f"scaled_dot_product_attention {library_ms:.5f} ms, bound "
                f"{r['bound_ms']:.5f} ms ({nbytes / 1e6:.1f} MB); "
                f"{r['bound_ms'] / ms:.1%} of the bound")
        out[name] = r
    return out


def _k5_inputs(shape, dtype, gen, dev):
    """x, y, b, w, beta for K5, w and beta away from the identity."""
    import torch

    d = shape[-1]

    def r(*s, scale=1.0, shift=0.0):
        return (torch.randn(s, generator=gen, device=dev) * scale + shift).to(dtype)
    return (r(*shape, scale=3.0, shift=0.5), r(*shape), r(d, scale=0.1),
            r(d, scale=0.3, shift=1.0), r(d, scale=0.1))


def _k5_args(mode, y, b) -> dict:
    return {"ln": {}, "y": {"y": y}, "y+b": {"y": y, "b": b}}[mode]


def k5_excess(got, want, x, w) -> float:
    """The largest error of K5's h past its tolerance (<= 0 within it): one
    ulp of the type at the row's scale (its largest |n|, at least 1) in the
    normalised value n (four in fp32, which shows every last-bit move of the
    statistics and of rsqrtf), carried through gamma and beta with their
    own roundings (csrc/add_layer_norm.cu: the fp32 statistics sum in
    another order). x: the updated residual."""
    import torch

    bits, min_exp = {torch.bfloat16: (8, -126), torch.float16: (11, -14),
                     torch.float32: (24, -126)}[x.dtype]

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** min_exp)))
                          - (bits - 1))
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    n = ((xf - mu) * torch.rsqrt(var + K5_EPS)).to(x.dtype).float()
    scale = n.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    wf = w.float()
    ulps = 4 if x.dtype == torch.float32 else 1
    tol = ulps * ulp(scale) * wf.abs() + ulp(n * wf) + ulp(want.float())
    return float(((got.float() - want.float()).abs() - tol).max())


def phase_k5(dev) -> dict:
    """K5, the add-and-LayerNorm kernel, against its plain version: rows 1,
    7, 40 and 64 at every Whisper width, the LayerNorm alone, after a
    product and after its bias, in bf16, f16 and fp32 (the residual bit for
    bit, h within `k5_excess`'s tolerance, 16-bit h at least 99% bit for
    bit); one graph replayed equals its eager call; then times at the cell's
    shape and tiny's width."""
    import torch

    from eioku_tpu_torch.ops.add_layer_norm import add_layer_norm, add_layer_norm_plain

    gen = torch.Generator(device=dev).manual_seed(5)
    worst, same = {}, {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        key = str(dtype).removeprefix("torch.")
        for rows in (1, 7, K5_ROWS, 64):
            for d in K5_WIDTHS:
                for mode in K5_MODES:
                    x, y, b, w, beta = _k5_inputs((rows, 1, d), dtype, gen, dev)
                    want_x, got_x = x.clone(), x.clone()
                    want = add_layer_norm_plain(want_x, w, beta, K5_EPS, **_k5_args(mode, y, b))
                    got = add_layer_norm(got_x, w, beta, K5_EPS, **_k5_args(mode, y, b))
                    err = k5_excess(got, want, want_x, w)
                    share = float((got == want).float().mean())
                    if not torch.equal(got_x, want_x) or not (
                            bool(torch.isfinite(got).all()) and err <= 0):
                        raise AssertionError(f"K5 {dtype} [{rows}, 1, {d}] {mode}: residual "
                                             f"equal {torch.equal(got_x, want_x)}, h past "
                                             f"the tolerance by {err}")
                    if dtype != torch.float32 and share < 0.99:
                        raise AssertionError(f"K5 {dtype} [{rows}, 1, {d}] {mode}: "
                                             f"{share:.2%} of h bit for bit")
                    worst[key] = max(worst.get(key, -1.0), err)
                    same[key] = min(same.get(key, 1.0), share)
    log(f"K5 against its plain version: largest excess over the tolerance {worst}; "
        f"least share of h bit for bit {same}")
    x, y, b, w, beta = _k5_inputs((K5_ROWS, 1, 1280), torch.bfloat16, gen, dev)
    start = x.clone()
    eager_x = x.clone()
    eager = add_layer_norm(eager_x, w, beta, K5_EPS, y=y, b=b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        add_layer_norm(x, w, beta, K5_EPS, y=y, b=b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = add_layer_norm(x, w, beta, K5_EPS, y=y, b=b)
    x.copy_(start)
    graph.replay()
    if not (torch.equal(out, eager) and torch.equal(x, eager_x)):
        raise AssertionError("K5's replay differs from its eager call")
    return {"excess_over_tolerance": worst, "bit_equal_least": same, **k5_times(dev)}


def k5_times(dev) -> dict:
    """K5 at the cell's step, [40, 1, 1280] bf16 after a product and its
    bias, and at tiny's width 384: back-to-back calls and replayed from a
    CUDA graph, over three input sets; the plain version (the op sequence
    the step ran before K5: the bias add, the residual add and
    `layer_norm`'s eager statistics) likewise; and `F.layer_norm` after the
    two adds as the library's yardstick, which the port never calls. The
    bound: x read and written, y read, h written and the three vectors
    read, once, at 3.35 TB/s; beside it the launch floor."""
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops.add_layer_norm import add_layer_norm, add_layer_norm_plain

    gen = torch.Generator(device=dev).manual_seed(10)
    floor_ms = launch_floor_ms()
    out = {"launch_floor_ms": floor_ms}
    for d in K5_TIMED:
        sets = [_k5_inputs((K5_ROWS, 1, d), torch.bfloat16, gen, dev) for _ in range(3)]

        def kernel(x, y, b, w, beta):
            return add_layer_norm(x, w, beta, K5_EPS, y=y, b=b)

        def plain(x, y, b, w, beta):
            return add_layer_norm_plain(x, w, beta, K5_EPS, y=y, b=b)

        def library(x, y, b, w, beta, d=d):
            return F.layer_norm(x + (y + b), (d,), w, beta, K5_EPS)
        nbytes = (4 * K5_ROWS * d + 3 * d) * 2
        r = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        calls = lambda fn, args: cuda_ms(fn, iters=200, args=args)  # noqa: E731
        for how, timer in (("calls", calls), ("graph", cuda_graph_ms)):
            ms, plain_ms, library_ms = (timer(fn, args=sets) for fn in (kernel, plain, library))
            r.update({f"{how}_ms": ms, f"{how}_plain_ms": plain_ms,
                      f"{how}_library_ms": library_ms})
            log(f"K5 [{K5_ROWS}, 1, {d}] bf16 after a product and its bias ({how}): kernel "
                f"{ms:.5f} ms, plain {plain_ms:.5f} ms, F.layer_norm after the adds "
                f"{library_ms:.5f} ms, bound {r['bound_ms']:.5f} ms "
                f"({nbytes / 1e3:.1f} KB), launch floor {floor_ms:.5f} ms")
        out[str(d)] = r
    return out


CLIP_COLORS = [(200, 40, 40), (40, 200, 40), (40, 40, 220), (220, 220, 60),
               (30, 30, 30), (200, 60, 200)]


def write_clip(path: str, seconds: int = CLIP_SECONDS, cut_every_s: int = CUT_EVERY_S,
               colors=CLIP_COLORS, seed: int = 0) -> int:
    """A 1280x720 mp4v clip of solid colour segments with per-pixel noise and
    a moving block; returns the number of planted cuts."""
    import cv2

    n_frames = seconds * CLIP_FPS
    seg = cut_every_s * CLIP_FPS
    rng = np.random.default_rng(seed)
    noise = [rng.integers(-4, 5, (CLIP_H, CLIP_W, 3)) for _ in range(4)]
    # per colour: a few noisy uint8 frames, cycled (BGR for cv2)
    bases = [[np.clip(np.array((b, g, r)) + n, 0, 255).astype(np.uint8)
              for n in noise] for r, g, b in colors]
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), CLIP_FPS,
                        (CLIP_W, CLIP_H))
    if not w.isOpened():
        raise RuntimeError("cv2.VideoWriter (mp4v) could not open " + path)
    try:
        for f in range(n_frames):
            frame = bases[(f // seg) % len(colors)][f % len(noise)].copy()
            x = (f * 7) % (CLIP_W - 200)
            frame[260:460, x:x + 200] = 255 - frame[260:460, x:x + 200]
            w.write(frame)
    finally:
        w.release()
    return n_frames // seg - 1


def _check_box_rows(rows: list[dict], label: str) -> None:
    for r in rows:
        p = r["payload"]
        vals = [p["confidence"], *p["bounding_box"].values()]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite {label} row {r}")


def _check_face_rows(rows: list[dict], label: str) -> None:
    """More than 0 rows, finite, each with a cluster id and a unit-norm
    512-d embedding (within the 5-place rounding)."""
    if not rows:
        raise AssertionError(f"{label}: no face rows at threshold {FACE_CONF}")
    _check_box_rows(rows, f"{label} face")
    worst = 0.0
    for r in rows:
        p = r["payload"]
        emb = np.asarray(p.get("embedding", []), np.float64)
        if emb.shape != (512,) or not p["cluster_id"]:
            raise AssertionError(f"{label}: face row without embedding or cluster: {p}")
        worst = max(worst, abs(float(np.linalg.norm(emb)) - 1.0))
    if not worst <= EMBED_NORM_TOL:
        raise AssertionError(f"{label}: an embedding's norm is off 1 by {worst}")
    log(f"{label}: {len(rows)} face rows, "
        f"{len({r['payload']['cluster_id'] for r in rows})} clusters, embeddings "
        f"unit norm within {worst:.2e} (tolerance {EMBED_NORM_TOL:.2e})")


def _check_place_rows(rows: list[dict], frames: int, label: str) -> None:
    """One row per sampled frame, each with 5 finite predictions, highest
    first."""
    if len(rows) != frames:
        raise AssertionError(f"{label}: {len(rows)} place rows for {frames} frames")
    for r in rows:
        conf = [p["confidence"] for p in r["payload"]["predictions"]]
        if len(conf) != 5 or not all(math.isfinite(c) for c in conf) \
                or conf != sorted(conf, reverse=True):
            raise AssertionError(f"{label}: bad place row {r}")


def _capture_nms(postprocess) -> list:
    """Wrap postprocess.nms_keep_mask so that each call appends its inputs
    and the keep mask it returned; the caller puts the original back."""
    calls, fn = [], postprocess.nms_keep_mask

    def captured(boxes, scores, classes, iou_threshold=0.45):
        keep = fn(boxes, scores, classes, iou_threshold)
        calls.append((boxes, scores, classes, iou_threshold, keep))
        return keep
    postprocess.nms_keep_mask = captured
    return calls


def _check_captured_nms(calls: list, k: int, label: str) -> int:
    """The kernel's keep masks on the candidates a run handed to the NMS
    equal the plain version's on the same tensors, exactly. Returns how many
    calls had one class among their valid candidates (the face detector's)."""
    from eioku_tpu_torch.ops.nms import nms_keep_mask_plain

    if not calls:
        raise AssertionError(f"{label}: no NMS call was captured")
    one_class = 0
    for boxes, scores, classes, thr, keep in calls:
        if boxes.shape[1] != k or not boxes.is_cuda:
            raise AssertionError(f"{label}: NMS got {tuple(boxes.shape)} on "
                                 f"{boxes.device}, expected K = {k} on the card")
        want = nms_keep_mask_plain(boxes, scores, classes, thr)
        mismatches = int((keep != want).sum())
        valid = scores > 0
        n_classes = int(classes[valid].unique().numel())
        one_class += n_classes == 1
        log(f"{label}: NMS on the run's candidates [B={boxes.shape[0]}, K={k}]: "
            f"{int(valid.sum())} valid, {int(want.sum())} kept, "
            f"{n_classes} classes, {mismatches} mismatches")
        if mismatches:
            raise AssertionError(f"{label}: K2's keep mask differs from the plain "
                                 f"version's on the run's candidates in {mismatches} slots")
    return one_class


def _k2_on_captured(call) -> dict:
    """K2's time on one captured call's candidates (calls and graph-replayed),
    its plain version's, and the bound for what these candidates need."""
    from eioku_tpu_torch.ops.nms import nms_keep_mask, nms_keep_mask_plain

    boxes, scores, classes, thr, keep = call
    b, k = scores.shape
    kernel = lambda: nms_keep_mask(boxes, scores, classes, thr)  # noqa: E731
    ops = _nms_pair_ops(keep.cpu().numpy(), scores.cpu().numpy(), classes.cpu().numpy())
    t_bytes = b * k * (16 + 4 + 4 + 1) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"batch": b, "k": k, "ms": cuda_ms(kernel),
            "cuda_graph_ms": cuda_graph_ms(kernel, args=((),)),
            "plain_ms": cuda_ms(lambda: nms_keep_mask_plain(boxes, scores, classes, thr),
                                iters=5, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _grid_frames(seconds: float, sample_fps: float = 4.0) -> int:
    """Frames of the clip on a consumer's grid, snapped to the scene base
    step as the combined pass snaps it."""
    base = max(int(round(CLIP_FPS / sample_fps)), 1)
    step = max(int(round(CLIP_FPS * seconds / base)), 1) * base
    return len(range(0, CLIP_SECONDS * CLIP_FPS, step))


def phase_slice(dev, workdir: str) -> dict:
    import torch

    from eioku_tpu_torch.ml import combined
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.yolo import postprocess
    from eioku_tpu_torch.ops import _cuda

    clip = os.path.join(workdir, "clip.mp4")
    t0 = time.perf_counter()
    cuts = write_clip(clip)
    log(f"clip: {CLIP_W}x{CLIP_H} {CLIP_FPS} fps {CLIP_SECONDS} s, {cuts} cuts, "
        f"written in {time.perf_counter() - t0:.1f} s")
    # one model cache for the run: 4d writes whisper-tiny.npz here, and
    # phase 4e's worker engine reads every model from it
    cache = os.path.join(workdir, "models")
    os.makedirs(cache, exist_ok=True)
    engine = InferenceEngine(model_cache_dir=cache, device="cuda")
    runs = {}

    def run(task: str, cfg: dict, label: str):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = engine.run_task(task, clip, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2**20
        counts = {k: len(v) for k, v in out.items()} if isinstance(out, dict) \
            else {task: len(out)}
        log(f"{label}: {wall:.3f} s wall, {CLIP_SECONDS / wall:.2f} video-s/s, "
            f"peak {peak:.1f} MiB, rows {counts}")
        runs[label] = {"wall_s": wall, "video_s_per_s": CLIP_SECONDS / wall,
                       "peak_mib": peak, "rows": counts}
        return out

    run("visual_analysis", VISUAL_CONFIG, "visual warm-up")  # models, cuDNN
    nms_keep_mask = postprocess.nms_keep_mask
    programs = {name: getattr(combined, name) for name in
                ("_detect_places_i420", "_detect_places_faces_i420")}
    try:
        routes = {name: _count_calls(combined, name) for name in programs}
        calls = _capture_nms(postprocess)
        _cuda.reset_launch_counts()
        out = run("visual_analysis", VISUAL_CONFIG, "visual measured")
        launches = _cuda.launch_counts()
        log(f"launches in the measured run: {launches}; fused programs called: "
            f"{ {k: len(v) for k, v in routes.items()} }")
        if not routes["_detect_places_i420"] or routes["_detect_places_faces_i420"]:
            raise AssertionError("the default run did not take the fused-places route "
                                 "with its own face consumer")
        if launches["nms"] != len(calls):
            raise AssertionError(f"K2 launched {launches['nms']} times for "
                                 f"{len(calls)} detect batches")
        if _check_captured_nms(calls, K2_MAIN_K, "visual_analysis") < 1:
            raise AssertionError("no one-class (face) NMS call in the measured run")
        face_call = next(c for c in calls if int(c[2][c[1] > 0].unique().numel()) == 1)
        object_call = next(c for c in calls if c is not face_call)
        k2_faces = _k2_on_captured(face_call)
        k2_objects = _k2_on_captured(object_call)
        for name, r in (("face", k2_faces), ("object", k2_objects)):
            log(f"K2 on the run's {name} candidates [B={r['batch']}, K={r['k']}]: "
                f"kernel {r['ms']:.5f} ms (calls), {r['cuda_graph_ms']:.5f} ms (graph), "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})")

        for v in routes.values():
            v.clear()
        calls = _capture_nms(postprocess)
        _cuda.reset_launch_counts()
        fused = run("visual_analysis", FUSED_CONFIG, "visual fully fused")
        fused_launches = _cuda.launch_counts()
        if not routes["_detect_places_faces_i420"]:
            raise AssertionError("the fully fused route never ran")
        if fused_launches["nms"] != len(calls) or \
                _check_captured_nms(calls, K2_MAIN_K, "fully fused") < 1:
            raise AssertionError("the fully fused run's NMS calls are off")

        calls = _capture_nms(postprocess)
        _cuda.reset_launch_counts()
        faces = run("face_detection", {**VISUAL_CONFIG["face_detection"],
                                       "batch_size": 64}, "face_detection task")
        if _cuda.launch_counts()["nms"] < 1 or \
                _check_captured_nms(calls, K2_MAIN_K, "face_detection task") < 1:
            raise AssertionError("the face_detection task never launched K2 on faces")
        places = run("place_classification", {}, "place_classification task")

        # the K > max_det NMS route, on the task that honours top_k (the
        # combined pass, like the JAX package's, ignores it)
        calls = _capture_nms(postprocess)
        _cuda.reset_launch_counts()
        big = run("object_detection", {"batch_size": 64, "top_k": K2_BIG_K},
                  f"object_detection top_k={K2_BIG_K}")
        big_launches = _cuda.launch_counts()["nms"]
        _check_captured_nms(calls, K2_BIG_K, f"object_detection top_k={K2_BIG_K}")
    finally:
        postprocess.nms_keep_mask = nms_keep_mask
        for name, fn in programs.items():
            setattr(combined, name, fn)
    for name in VISUAL_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the visual pass never launched {name}")
    for label, res in (("measured", out), ("fully fused", fused)):
        if len(res["scene_detection"]) != cuts + 1:
            raise AssertionError(f"{label}: expected {cuts + 1} scenes, got "
                                 f"{res['scene_detection']}")
        _check_box_rows(res["object_detection"], f"{label} object")
        _check_face_rows(res["face_detection"], f"visual {label}")
        _check_place_rows(res["place_classification"], _grid_frames(1.0),
                          f"visual {label}")
    _check_face_rows(faces, "face_detection task")
    _check_place_rows(places, CLIP_SECONDS, "place_classification task")
    if big_launches < 1:
        raise AssertionError("the top_k=1024 route never launched the NMS kernel")
    _check_box_rows(big, "object")

    # reference: the port's CPU path (plain versions) gives the same scenes
    cpu_scenes = InferenceEngine(device="cpu").run_task(
        "visual_analysis", clip, {"scene_detection": {}})["scene_detection"]
    if cpu_scenes != out["scene_detection"]:
        raise AssertionError(f"scene rows differ from the CPU path:\n"
                             f"{cpu_scenes}\n{out['scene_detection']}")
    log("scene rows equal the CPU path's")
    measured = runs["visual measured"]
    return {"launches": launches, "wall_s": measured["wall_s"],
            "video_s_per_s": measured["video_s_per_s"], "peak_mib": measured["peak_mib"],
            "rows": measured["rows"], "runs": runs,
            "nms_launches_per_run": {"visual measured": launches["nms"],
                                     "visual fully fused": fused_launches["nms"]},
            "k2_faces": k2_faces, "k2_objects": k2_objects, "cpu_scenes": cpu_scenes}


def _card_vs_cpu(name: str, model, x) -> None:
    """model (fp32, on the CPU) on x, on the CPU and on the card (TF32 off):
    each output within MODEL_TOL of the CPU's, relative to its largest
    |value|."""
    import torch

    with torch.no_grad():
        ref = model(x)
        got = model.to("cuda")(x.to("cuda"))
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    for part, (r, g) in enumerate(zip(refs, gots)):
        err = float((g.cpu() - r).abs().max())
        scale = float(r.abs().max())
        log(f"{name} fp32 output {part} card vs CPU: max abs err {err:.3e} "
            f"(max |value| {scale:.3e})")
        if not err <= MODEL_TOL * max(scale, 1.0):
            raise AssertionError(f"{name} outputs differ: {err} vs scale {scale}")


def phase_logits_reference(dev) -> None:
    """YOLOv8n, ResNet18-Places365 and ArcFace iresnet18 at fp32 on the card
    (TF32 off) against the CPU on small batches."""
    import torch

    from eioku_tpu_torch.models.face_embed.model import IResNet18
    from eioku_tpu_torch.models.resnet.model import ResNet18
    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm

    torch.backends.cudnn.allow_tf32 = False  # fp32 comparison: no TF32 convs
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(2)
        _card_vs_cpu("yolov8n", fold_batchnorm(YOLOv8(
            YoloConfig("yolov8n"), generator=torch.Generator().manual_seed(0))).eval(),
            torch.rand((2, 3, 384, 640), generator=gen))
        _card_vs_cpu("resnet18-places365", ResNet18(
            generator=torch.Generator().manual_seed(0)).eval(),
            torch.randn((2, 3, 224, 224), generator=gen))
        _card_vs_cpu("arcface-iresnet18", IResNet18(
            generator=torch.Generator().manual_seed(0)).eval(),
            torch.rand((2, 3, 112, 112), generator=gen) * 2 - 1)
    finally:
        torch.backends.cudnn.allow_tf32 = True


def write_speech_wav(path: str) -> None:
    """AUDIO_SECONDS of 16 kHz mono: a gliding tone with noise in every 30 s
    window except SILENT_WINDOW, which is digitally silent."""
    import wave

    sr = 16000
    rng = np.random.default_rng(0)
    t = np.arange(sr * AUDIO_SECONDS) / sr
    x = 0.3 * np.sin(2 * np.pi * (180 + 40 * np.sin(0.5 * t)) * t) \
        + 0.05 * rng.standard_normal(t.shape)
    x[SILENT_WINDOW * 30 * sr:(SILENT_WINDOW + 1) * 30 * sr] = 0.0
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _count_calls(module, name: str) -> list:
    """Wrap module.name so that each call appends to the returned list."""
    calls, fn = [], getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    setattr(module, name, counted)
    return calls


@contextlib.contextmanager
def _counting(module, name: str, record=lambda out: 1):
    """Wrap module.name for the duration of a `with`, which yields a list
    that each call appends record(its return value) to."""
    fn, calls = getattr(module, name), []

    def counted(*a, **kw):
        out = fn(*a, **kw)
        calls.append(record(out))
        return out
    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def phase_transcription(dev, wav: str) -> dict:
    import torch

    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.whisper.model import WhisperConfig
    from eioku_tpu_torch.ops import _cuda

    n_layers = WhisperConfig(WHISPER_CONFIG["model"]).n_enc_layers
    engine = InferenceEngine(device=dev)
    enc_calls = _count_calls(transcribe, "whisper_encode")

    def run(label: str) -> tuple[list, float]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = engine.run_task("transcription", wav, WHISPER_CONFIG)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        log(f"transcription {label}: {wall:.3f} s wall, "
            f"{AUDIO_SECONDS / wall:.2f} audio-s/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, {len(out)} rows")
        return out, wall

    run("warm-up")  # random large-v3 init on the card, cuBLAS handles
    enc_calls.clear()
    _cuda.reset_launch_counts()
    out, wall = run("measured")
    launches = _cuda.launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"launches in the measured transcription: {launches}; "
        f"{len(enc_calls)} encoder calls")
    if launches["flash_attention"] != n_layers * len(enc_calls) or not enc_calls:
        raise AssertionError(f"K3 launched {launches['flash_attention']} times for "
                             f"{len(enc_calls)} encoder calls of {n_layers} layers")
    if out != []:
        raise AssertionError(f"random weights must emit no rows, got {out[:3]}")
    return {"launches": launches, "wall_s": wall,
            "audio_s_per_s": AUDIO_SECONDS / wall, "peak_mib": peak_mib,
            "encoder_calls": len(enc_calls),
            "float16": _transcription_f16(dev, wav, engine, enc_calls, n_layers)}


def _transcription_f16(dev, wav: str, engine, enc_calls: list, n_layers: int) -> dict:
    """4b the same transcription at compute_dtype float16 (faster-whisper's
    GPU compute type): K3's f16 route in every encoder layer; one encoder
    output of the random full-width model must be finite in f16."""
    import torch

    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import whisper_encode
    from eioku_tpu_torch.ops import _cuda

    cfg16 = {**WHISPER_CONFIG, "compute_dtype": "float16"}
    engine.run_task("transcription", wav, cfg16)  # warm-up: the f16 model
    enc_calls.clear()
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = engine.run_task("transcription", wav, cfg16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _cuda.launch_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**20
    if launches != n_layers * len(enc_calls) or not enc_calls or out != []:
        raise AssertionError(f"f16 transcription: K3 {launches} for {len(enc_calls)} "
                             f"encoder calls of {n_layers} layers, rows {out[:3]}")
    model, cfg, _ = transcribe._load_model(
        cfg16["model"], None, "float16", cfg16["random_full_size"], dev)
    x = torch.zeros(SAMPLES_PER_WINDOW, device=dev)
    x[:16000] = 0.1
    enc = whisper_encode(model, log_mel_spectrogram(x[None], n_mels=cfg.n_mels))
    if enc.dtype != torch.float16 or not bool(torch.isfinite(enc).all()):
        raise AssertionError(f"f16 encoder output: {enc.dtype}, finite "
                             f"{bool(torch.isfinite(enc).all())}")
    log(f"transcription float16: {wall:.3f} s wall, {AUDIO_SECONDS / wall:.2f} "
        f"audio-s/s, peak {peak:.1f} MiB, K3 {launches} launches for "
        f"{len(enc_calls)} encoder calls")
    return {"wall_s": wall, "audio_s_per_s": AUDIO_SECONDS / wall, "peak_mib": peak,
            "k3_launches": launches, "encoder_calls": len(enc_calls)}


def phase_production_decode(dev, wav: str) -> dict:
    """whisper_decode_windows at large-v3, beam 5, 224 tokens, EOT suppressed
    (every row pays all 224 positions), on the 4 voiced windows."""
    import torch

    from eioku_tpu_torch.ml import audio_io, transcribe
    from eioku_tpu_torch.models.whisper.decoding import (
        build_suppress_masks,
        whisper_decode_windows,
    )
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import whisper_encode
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    model, cfg, _ = transcribe._load_model(
        WHISPER_CONFIG["model"], None, "bfloat16", WHISPER_CONFIG["random_full_size"],
        dev)
    windows = audio_io.split_windows(audio_io.load_wav(wav))
    mel = log_mel_spectrogram(torch.from_numpy(np.stack([w for _, w in windows]))
                              .to(dev), n_mels=cfg.n_mels)
    enc = whisper_encode(model, mel)
    tk = WhisperTokens(cfg.vocab_size)
    sot = tk.sot_sequence("en")
    init = torch.tensor([sot] * len(windows), device=dev)
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    sup_a[tk.eot] = True
    max_len = WHISPER_CONFIG["max_tokens"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, avg_lp, _ = whisper_decode_windows(model, enc, init, sup_a, sup_b,
                                            max_len=max_len, beam_size=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if not bool(torch.isfinite(avg_lp).all()) or bool((out[:, len(sot):] == tk.eot).any()):
        raise AssertionError("production decode: non-finite scores or an EOT")
    tokens = len(windows) * (max_len - len(sot))
    audio_s = 30.0 * len(windows)
    log(f"production decode {cfg.variant} beam 5, {len(windows)} windows x "
        f"{max_len - len(sot)} tokens: {wall:.3f} s, {audio_s / wall:.2f} audio-s/s, "
        f"{tokens / wall:.1f} decoded tokens/s")
    return {"wall_s": wall, "audio_s_per_s": audio_s / wall,
            "tokens_per_s": tokens / wall, "windows": len(windows)}


def _first_divergence_margin(ref_rows, rows, model, enc, sup_a,
                             labels: tuple[str, str] = ("CPU", "card")) -> float:
    """Where `rows` first part from `ref_rows` (token rows on the CPU): the
    reference's top-2 log-prob margin at that step (decode_full of `model`
    on the reference's prefix over `enc`, on enc's device); 0 where no row
    parts."""
    import torch

    from eioku_tpu_torch.models.whisper.model import whisper_decode_full

    diff = (ref_rows != rows).nonzero()
    if len(diff) == 0:
        return 0.0
    w, p = (int(v) for v in diff[0])
    d = enc.device
    logits = whisper_decode_full(model, ref_rows[w:w + 1, :p].to(d), enc[w:w + 1])
    lp = torch.log_softmax(logits[0, -1].float().masked_fill(sup_a.to(d), -1e30), dim=-1)
    top2 = lp.topk(2).values
    margin = float(top2[0] - top2[1])
    log(f"{labels[1]} and {labels[0]} tokens first part in window {w} at position {p}: "
        f"{labels[0]} {int(ref_rows[w, p])}, {labels[1]} {int(rows[w, p])}; "
        f"{labels[0]} top-2 log-prob margin there {margin:.3e}")
    return margin


def _tiny_card_vs_cpu_margin(cpu_model, card_model, wav: str, dev) -> float:
    """Beam-5 decodes of the wav's windows on the CPU and on the card, and
    the CPU's top-2 margin where their tokens first part."""
    import torch

    from eioku_tpu_torch.ml import audio_io
    from eioku_tpu_torch.models.whisper.decoding import (
        build_suppress_masks,
        whisper_decode_windows,
    )
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import whisper_encode
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens

    tk = WhisperTokens(cpu_model.cfg.vocab_size)
    wavs = torch.from_numpy(np.stack([w for _, w in audio_io.split_windows(
        audio_io.load_wav(wav))]))
    sot = tk.sot_sequence("en", timestamps=True)
    sup_a, sup_b = build_suppress_masks(tk, timestamps=True)
    rows, encs = {}, {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")),
                           ("card", card_model, dev)):
        encs[name] = whisper_encode(model, log_mel_spectrogram(wavs.to(d), 80))
        init = torch.tensor([sot] * len(wavs), device=d)
        rows[name] = whisper_decode_windows(
            model, encs[name], init, sup_a, sup_b, max_len=TINY_CONFIG["max_tokens"],
            beam_size=5)[0].cpu()
    return _first_divergence_margin(rows["cpu"], rows["card"], cpu_model, encs["cpu"], sup_a)


def phase_card_vs_cpu(dev, wav: str, workdir: str) -> dict:
    import torch

    from eioku_tpu_torch.ml import audio_io, transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import (
        WhisperConfig,
        init_whisper,
        whisper_encode,
    )
    from eioku_tpu_torch.models.whisper.weights import load_whisper_checkpoint

    cache = os.path.join(workdir, "models")
    os.makedirs(cache, exist_ok=True)
    cfg = WhisperConfig("tiny")
    tree = init_whisper(cfg, torch.Generator().manual_seed(0))
    np.savez(os.path.join(cache, "whisper-tiny.npz"),
             **{k: v.detach().numpy() for k, v in tree.state_dict().items()})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        path = os.path.join(cache, "whisper-tiny.npz")
        cpu_model = load_whisper_checkpoint(path, cfg, "cpu")
        card_model = load_whisper_checkpoint(path, cfg, dev)
        wav0 = torch.from_numpy(audio_io.split_windows(audio_io.load_wav(wav))[0][1])
        mel = log_mel_spectrogram(wav0[None], 80)
        enc_cpu = whisper_encode(cpu_model, mel)
        enc_card = whisper_encode(card_model, mel.to(dev)).cpu()
        enc_err = float((enc_card - enc_cpu).abs().max())
        log(f"tiny fp32 encoder states card vs CPU: max abs err {enc_err:.3e} "
            f"(max |state| {float(enc_cpu.abs().max()):.3e})")
        if not enc_err <= ENC_TOL:
            raise AssertionError(f"encoder states differ: {enc_err}")
        transcribe._load_model.cache_clear()
        rows = {}
        for name in ("cuda", "cpu"):
            t = time.perf_counter()
            rows[name] = InferenceEngine(model_cache_dir=cache, device=(
                dev if name == "cuda" else "cpu")).run_task(
                "transcription", wav, TINY_CONFIG)
            log(f"tiny pretrained-path transcription on {name}: "
                f"{time.perf_counter() - t:.3f} s, {len(rows[name])} rows")
        strip = lambda rs: [{**r, "payload": {k: v for k, v in r["payload"].items()  # noqa: E731
                                              if k != "confidence"}} for r in rs]
        conf = [(a["payload"]["confidence"], b["payload"]["confidence"])
                for a, b in zip(rows["cuda"], rows["cpu"])]
        equal = strip(rows["cuda"]) == strip(rows["cpu"]) and \
            all(abs(a - b) <= 1e-4 for a, b in conf)
        margin = 0.0
        if not rows["cpu"]:
            raise AssertionError("the pretrained path emitted no rows on the CPU")
        if equal:
            log("tiny pretrained-path rows: card equals CPU")
        else:
            margin = _tiny_card_vs_cpu_margin(cpu_model, card_model, wav, dev)
            if not margin < TOKEN_MARGIN_TOL:
                raise AssertionError(f"card rows differ from the CPU's and the CPU's "
                                     f"top-2 margin is {margin} >= {TOKEN_MARGIN_TOL}")
        t = time.perf_counter()
        ladder = InferenceEngine(model_cache_dir=cache, device=dev).run_task(
            "transcription", wav, {k: v for k, v in TINY_CONFIG.items()
                                   if k != "temperatures"})
        if not all(math.isfinite(r["payload"]["confidence"]) for r in ladder):
            raise AssertionError("the temperature ladder gave non-finite rows")
        log(f"tiny with the temperature ladder on the card: "
            f"{time.perf_counter() - t:.3f} s, {len(ladder)} rows")
        options = _tiny_options_card_vs_cpu(dev, wav, workdir, cache)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        transcribe._load_model.cache_clear()
    return {"enc_max_abs_err": enc_err, "rows_equal": equal,
            "rows": len(rows["cpu"]), "margin": margin, "options": options}


def _same_rows(a: list, b: list) -> bool:
    """Rows equal but for the confidence, which may differ by 1e-4."""
    strip = lambda rs: [{**r, "payload": {k: v for k, v in r["payload"].items()  # noqa: E731
                                          if k != "confidence"}} for r in rs]
    return strip(a) == strip(b) and all(
        abs(x["payload"]["confidence"] - y["payload"]["confidence"]) <= 1e-4
        for x, y in zip(a, b))


def _tiny_options_card_vs_cpu(dev, wav: str, workdir: str, cache: str) -> dict:
    """4d with each Whisper option on: the tiny tree, in a cache of its own
    with a vocabulary (so that words exist), transcribed on the card (fp32,
    TF32 off) and on the CPU; the rows must be equal."""
    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine

    opt_cache = os.path.join(workdir, "models_options")
    os.makedirs(opt_cache)
    os.link(os.path.join(cache, "whisper-tiny.npz"),
            os.path.join(opt_cache, "whisper-tiny.npz"))
    write_tokenizer_files(opt_cache)
    out = {}
    for name, option in TINY_OPTIONS.items():
        rows = {}
        with _counting(transcribe, "speculative_greedy_decode",
                       lambda out: out[1]) as rates:
            for where in ("cuda", "cpu"):
                rows[where] = InferenceEngine(
                    model_cache_dir=opt_cache, device=dev if where == "cuda" else "cpu"
                ).run_task("transcription", wav, {**TINY_CONFIG, **option})
        words = sum(len(r["payload"]["words"]) for r in rows["cpu"])
        if not rows["cpu"] or not _same_rows(rows["cuda"], rows["cpu"]):
            raise AssertionError(f"tiny {name}: card rows ({len(rows['cuda'])}) differ "
                                 f"from the CPU's ({len(rows['cpu'])})")
        if (name == "word_timestamps") != bool(words) or \
                (name == "draft_model") != bool(rates):
            raise AssertionError(f"tiny {name}: {words} words, {len(rates)} "
                                 f"speculative decodes")
        out[name] = {"rows": len(rows["cpu"]), "words": words, "accept_rates": rates}
        log(f"tiny {name}: card rows equal the CPU's ({len(rows['cpu'])} rows, "
            f"{words} words, accept rates {out[name]['accept_rates']})")
    return out


def _fts5_enabled() -> bool:
    import sqlite3

    conn = sqlite3.connect(":memory:")
    try:
        return any("FTS5" in r[0] for r in conn.execute("PRAGMA compile_options"))
    finally:
        conn.close()


def _check_rows_equal_engine(db, returned, producer: str, label: str) -> int:
    """The DB's artifacts of each sub type, in order, equal the rows built
    from what the engine returned inside the worker. Returns their count."""
    from eioku_tpu_torch.domain.task_registry import TASK_REGISTRY

    n = 0
    for sub, results in returned.items():
        artifact_type = TASK_REGISTRY[sub].artifact_types[0]
        want = [(artifact_type, r["span_start_ms"], r["span_end_ms"], r["payload"], 1,
                 producer) for r in results]
        got = [(r[0], r[1], r[2], json.loads(r[3]), r[4], r[5]) for r in db.query(
            "SELECT artifact_type, span_start_ms, span_end_ms, payload_json, "
            "schema_version, producer FROM artifacts WHERE artifact_type = ? "
            "ORDER BY rowid", (artifact_type,))]
        if got != want:
            raise AssertionError(f"{label}: the DB's {artifact_type} rows ({len(got)}) "
                                 f"differ from the engine's ({len(want)})")
        n += len(got)
    log(f"{label}: the DB's rows equal the engine's ({n} artifacts, "
        f"{ {sub: len(r) for sub, r in returned.items()} })")
    return n


def phase_worker(dev, workdir: str, clip: str, wav: str, cpu_scenes: list,
                 card: str) -> dict:
    """The port's host stack on the card: discovery, the queue, the worker's
    process_ml_task, the artifact and projection rows, find and jump."""
    import asyncio
    import re
    import uuid

    import torch

    from eioku_tpu_torch.api.app import build_context
    from eioku_tpu_torch.config.settings import AppConfig
    from eioku_tpu_torch.domain.models import TaskStatus, Video
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.queue.worker import WorkerSettings
    from eioku_tpu_torch.utils.hashing import hash_file
    from eioku_tpu_torch.workers.main import build_worker

    if not _fts5_enabled():
        raise AssertionError("this host's sqlite3 is built without FTS5: the "
                             "transcript and OCR projections need it")
    root = os.path.join(workdir, "worker")
    videos = os.path.join(root, "videos")
    os.makedirs(videos)
    os.link(clip, os.path.join(videos, "clip.mp4"))
    cache = os.path.join(workdir, "models")  # whisper-tiny.npz from phase 4d
    write_minilm_checkpoint(cache)  # the semantic index's MiniLM
    config = AppConfig(
        scan_paths=[videos], database_url=f"sqlite:///{root}/eioku.db",
        model_cache_dir=cache, combined_visual=True, semantic_search=True,
        active_task_types=["scene_detection", "object_detection", "face_detection",
                           "place_classification", "ocr", "metadata_extraction"],
        task_settings={k: v for k, v in VISUAL_CONFIG.items() if v})
    if not config.visual_search:
        raise AssertionError("visual_search is off by default")
    ctx = build_context(config)
    seeks = _count_calls(ctx.extra["visual_index"], "_decode_at")
    api_startup(ctx)  # the API's start-up: path merge, discovery, enqueue
    log(f"worker: discovery at the API's start-up: {ctx.videos.count()} video, tasks "
        f"{sorted(t.task_type for t in ctx.tasks.find(limit=20))}")
    engine = InferenceEngine(model_cache_dir=cache, model_profile=config.model_profile,
                             device=dev)
    returned, engine_s, worker_s = {}, {}, {}
    run_task = engine.run_task

    def recording_run_task(task_type, video_path, cfg):
        t = time.perf_counter()
        out = run_task(task_type, video_path, cfg)
        torch.cuda.synchronize()
        engine_s[task_type] = time.perf_counter() - t
        returned[task_type] = out
        return out
    engine.run_task = recording_run_task
    worker = build_worker(app_ctx=ctx, engine=engine,
                          settings=WorkerSettings(max_jobs=1, poll_delay_s=0.01))
    process = worker.functions["process_ml_task"]

    async def timed_process(job_ctx, task_id, task_type, *args, **kwargs):
        t = time.perf_counter()
        try:
            return await process(job_ctx, task_id, task_type, *args, **kwargs)
        finally:
            worker_s[task_type] = time.perf_counter() - t
    worker.register("process_ml_task", timed_process)

    def drain(label: str) -> dict:
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        asyncio.run(worker.drain())
        wall = time.perf_counter() - t
        launches = _cuda.launch_counts()
        log(f"worker {label}: drained in {wall:.3f} s; launches {launches}")
        return launches

    launches = drain("visual")
    tasks = {t.task_type: t for t in ctx.tasks.find(limit=20)}
    if sorted(tasks) != ["metadata_extraction", "semantic_indexing", "visual_analysis",
                         "visual_indexing"] or any(
            t.status is not TaskStatus.COMPLETED for t in tasks.values()):
        raise AssertionError("worker: tasks not all completed: " + str(
            [(t.task_type, t.status.value, t.error) for t in tasks.values()]))
    followups = {t: worker_s[t] for t in ("semantic_indexing", "visual_indexing")}
    if launches["scene_diff"] != 1 or launches["nms"] != 2:
        raise AssertionError(f"worker: expected K1 x1 and K2 x2 (objects + faces), "
                             f"got {launches}")
    producer = engine.producer_name
    visual = returned["visual_analysis"]
    n_visual = _check_rows_equal_engine(ctx.db, visual, producer, "worker visual_analysis")
    _check_rows_equal_engine(ctx.db, {"metadata_extraction":
                                      returned["metadata_extraction"]},
                             producer, "worker metadata_extraction")
    if visual["scene_detection"] != cpu_scenes:
        raise AssertionError("worker: scene rows differ from the CPU path's")
    video = ctx.videos.list()[0]
    db = ctx.db
    faces = visual["face_detection"]
    _check_face_rows(faces, "worker visual_analysis")
    counts = {t: db.scalar(f"SELECT COUNT(*) FROM {t}") for t in
              ("scene_ranges", "object_labels", "face_clusters")}
    clusters = {r[0] for r in db.query("SELECT DISTINCT cluster_id FROM face_clusters")}
    if counts["scene_ranges"] != len(visual["scene_detection"]) \
            or counts["object_labels"] != len(visual["object_detection"]) \
            or not counts["object_labels"] or counts["face_clusters"] != len(faces) \
            or clusters != {r["payload"]["cluster_id"] for r in faces}:
        raise AssertionError(f"worker: projections {counts} disagree with the artifacts")
    if video.duration_ms != CLIP_SECONDS * 1000:
        raise AssertionError(f"worker: video duration_ms {video.duration_ms}")
    hit = ctx.jump.jump(video.id, "scene", 15000)
    if hit is None or abs(hit["start_ms"] - 2 * CUT_EVERY_S * 1000) > 300:
        raise AssertionError(f"worker: next scene after 15 s is {hit}")
    log(f"worker: projections {counts}, {len(clusters)} face clusters; next scene "
        f"after 15 s starts at {hit['start_ms']} ms")
    ocr = _check_ocr_and_visual_followups(ctx, video.id, visual, len(seeks))

    # an ad-hoc transcription job on the wav, through the producer
    wav_video = Video(path=wav, file_hash=hash_file(wav), size_bytes=os.path.getsize(wav))
    ctx.videos.save(wav_video)
    task_id = str(uuid.uuid4())
    ctx.producer.enqueue_task(task_id, "transcription", wav_video.id, wav, TINY_CONFIG)
    tr_launches = drain("transcription")
    transcript = returned["transcription"]
    if tr_launches["flash_attention"] < 1:
        raise AssertionError("worker: the transcription job never launched K3")
    if ctx.tasks.get(task_id).status is not TaskStatus.COMPLETED:
        raise AssertionError(f"worker: transcription {ctx.tasks.get(task_id).error}")
    n_transcript = _check_rows_equal_engine(ctx.db, {"transcription": transcript},
                                            producer, "worker transcription")
    words = sorted({w for r in transcript
                    for w in re.findall(r"[A-Za-z0-9]+", r["payload"]["text"])},
                   key=lambda w: (-len(w), w))
    if not words:
        raise AssertionError(f"worker: no alphanumeric word in {len(transcript)} rows")
    word = words[0]
    fts = db.scalar("SELECT COUNT(*) FROM transcript_fts WHERE transcript_fts MATCH ?",
                    (f'"{word}"',))
    found = ctx.find.find(wav_video.id, word)
    if not fts or not found:
        raise AssertionError(f"worker: find {word!r}: {fts} FTS rows, hits {found}")
    log(f"worker: find {word!r} in the transcript: {len(found)} hits ({fts} FTS rows), "
        f"first at {found[0]['jump_to']}")
    semantic = _check_semantic_followup(ctx, wav_video.id, transcript)
    # an explicit speaker_diarization job: discovery creates none
    dz_id = str(uuid.uuid4())
    ctx.producer.enqueue_task(dz_id, "speaker_diarization", wav_video.id, wav, {})
    drain("speaker_diarization")
    if ctx.tasks.get(dz_id).status is not TaskStatus.COMPLETED:
        raise AssertionError(f"worker: speaker_diarization {ctx.tasks.get(dz_id).error}")
    n_turns = _check_rows_equal_engine(
        ctx.db, {"speaker_diarization": returned["speaker_diarization"]}, producer,
        "worker speaker_diarization")
    if not n_turns:
        raise AssertionError("worker: speaker_diarization wrote no speaker.turn rows")
    per_task = {t: {"worker_s": worker_s[t], "engine_s": engine_s[t],
                    "host_stack_s": worker_s[t] - engine_s[t]}
                for t in ("visual_analysis", "metadata_extraction", "transcription",
                          "speaker_diarization")}
    per_task["speaker_diarization"]["artifacts"] = n_turns

    # the same task re-run under EIOKU_PROFILE_DIR: the handler's
    # maybe_profile must trace the engine's thread, K3 included; the walls'
    # difference is what the trace costs
    prof_dir = os.path.join(root, "profile")
    os.environ["EIOKU_PROFILE_DIR"] = prof_dir
    try:
        ctx.tasks.update_status(task_id, TaskStatus.PENDING)
        ctx.producer.enqueue_task(task_id, "transcription", wav_video.id, wav, TINY_CONFIG)
        drain("transcription, profiled")
    finally:
        del os.environ["EIOKU_PROFILE_DIR"]
    (trace,) = glob.glob(os.path.join(prof_dir, "transcription-*", "trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k3 = [k for k in kernels if "flash" in k]
    ops = [e for e in events if str(e.get("name", "")).startswith("aten::")]
    if not k3 or not ops:
        raise AssertionError(f"worker: the profiled job's trace holds {len(ops)} aten ops "
                             f"and {len(k3)} K3 kernels of {len(kernels)}")
    per_task["transcription"]["profiled_worker_s"] = worker_s["transcription"]
    log(f"worker transcription under the profiler: worker {worker_s['transcription']:.3f} s "
        f"(unprofiled {per_task['transcription']['worker_s']:.3f} s); trace: {len(events)} "
        f"events, {len(ops)} aten ops, {len(kernels)} kernels, {len(k3)} of them K3")
    per_task["visual_analysis"].update({
        "artifacts": n_visual,
        "artifacts_per_s": n_visual / worker_s["visual_analysis"],
        "host_stack_artifacts_per_s": n_visual / per_task["visual_analysis"]["host_stack_s"],
        "video_s_per_s": CLIP_SECONDS / worker_s["visual_analysis"]})
    per_task["transcription"].update({
        "artifacts": n_transcript, "audio_s_per_s": AUDIO_SECONDS / worker_s["transcription"]})
    for t, r in per_task.items():
        log(f"worker {t}: worker {r['worker_s']:.3f} s, engine {r['engine_s']:.3f} s, "
            f"host stack {r['host_stack_s'] * 1e3:.1f} ms ({card})")
    for t, wall in followups.items():
        log(f"worker {t} (visual_analysis' follow-up): {wall:.3f} s ({card})")
    return {"tasks": per_task, "followups_s": followups, "launches": launches,
            "transcription_launches": tr_launches, "find_word": word,
            "semantic_indexing": semantic, "ocr_and_visual_index": ocr, "card": card}


def api_startup(ctx) -> None:
    """create_app's start-up and shut-down hooks on `ctx`, as the API process
    runs them (the worker discovers nothing itself): the configured scan
    paths merge into the database and discovery enqueues their videos'
    tasks."""
    import asyncio

    from eioku_tpu_torch.api.app import create_app

    app = create_app(ctx=ctx, start_reconciler=False)

    async def lifespan():
        for hook in app.on_startup + app.on_shutdown:
            await hook()
    asyncio.run(lifespan())


def _check_ocr_and_visual_followups(ctx, video_id: str, visual: dict, seeks: int) -> dict:
    """The visual task's OCR rows are in ocr_fts and found by find; its
    semantic_indexing follow-up indexed them; its visual_indexing follow-up
    embedded one keyframe per scene midpoint on the card, every one read
    from the pass's keyframe cache (no seek-decode)."""
    import re

    ocr = visual["ocr"]
    fts = ctx.db.scalar("SELECT COUNT(*) FROM ocr_fts_meta WHERE asset_id = ?", (video_id,))
    if not ocr or fts != len(ocr):
        raise AssertionError(f"worker: {len(ocr)} OCR rows, {fts} ocr_fts rows")
    # FTS5's unicode61 tokens: runs of letters and digits
    words = sorted({w for r in ocr for w in re.findall(r"[^\W_]+", r["payload"]["text"])},
                   key=lambda w: (-len(w), w))
    if not words:
        raise AssertionError(f"worker: no word in {len(ocr)} OCR rows")
    found = ctx.find.find(video_id, words[0])
    if not found:
        raise AssertionError(f"worker: find {words[0]!r} in the OCR text: no hit")
    chunks = ctx.db.scalar("SELECT COUNT(*) FROM embedding_chunks WHERE asset_id = ? "
                           "AND source = 'ocr'", (video_id,))
    if not chunks:
        raise AssertionError("worker: semantic_indexing indexed no OCR chunk")
    scenes = visual["scene_detection"]
    rows = [tuple(r) for r in ctx.db.query(
        "SELECT ts_ms, scene_index FROM frame_embeddings WHERE asset_id = ? ORDER BY slot",
        (video_id,))]
    want = [((s["span_start_ms"] + s["span_end_ms"]) // 2, s["payload"]["scene_index"])
            for s in scenes]
    index = ctx.extra["visual_index"]
    if rows != want or seeks or index._dev.type != "cuda":
        raise AssertionError(f"worker: visual_indexing rows {rows} (want {want}), "
                             f"{seeks} seek-decodes, device {index._dev}")
    hits = index.search("a red frame", top_k=len(rows))
    if sorted(h["ts_ms"] for h in hits) != [r[0] for r in rows]:
        raise AssertionError(f"worker: visual search gave {hits}")
    log(f"worker: {len(ocr)} OCR rows in ocr_fts, find {words[0]!r} -> {len(found)} hits; "
        f"{chunks} OCR chunks indexed; {len(rows)} keyframes embedded from the cache "
        f"({seeks} seek-decodes), visual search returns all of them")
    return {"ocr_rows": len(ocr), "find_word": words[0], "ocr_chunks": chunks,
            "keyframes": len(rows), "seek_decodes": seeks}


def _check_semantic_followup(ctx, video_id: str, transcript: list) -> dict:
    """The transcription's semantic_indexing follow-up completed on the
    card's index: one embedding_chunks row per chunk of the engine's
    transcript rows (the task's default chunking), and a search on a
    chunk's text returns its video at the chunk's span."""
    from eioku_tpu_torch.domain.models import TaskStatus
    from eioku_tpu_torch.index.semantic import chunk_segments

    (sem,) = ctx.tasks.find(video_id=video_id, task_type="semantic_indexing")
    if sem.status is not TaskStatus.COMPLETED:
        raise AssertionError(f"worker: semantic_indexing {sem.status} {sem.error}")
    cfg = ctx.config.settings_for("semantic_indexing")
    chunks = chunk_segments([{"text": r["payload"]["text"], "start_ms": r["span_start_ms"],
                              "end_ms": r["span_end_ms"]} for r in transcript],
                            cfg["chunk_chars"], cfg["overlap_chars"])
    rows = [tuple(r) for r in ctx.db.query(
        "SELECT text, start_ms, end_ms FROM embedding_chunks WHERE asset_id = ? "
        "ORDER BY slot", (video_id,))]
    if rows != [(c["text"], c["start_ms"], c["end_ms"]) for c in chunks] or not rows:
        raise AssertionError(f"worker: {len(rows)} embedding_chunks rows for "
                             f"{len(chunks)} chunks of the engine's transcript")
    index = ctx.extra["semantic_index"]
    if index._dev.type != "cuda":
        raise AssertionError(f"worker: the semantic index ran on {index._dev}")
    text, start_ms, end_ms = rows[-1]
    hits = index.search(text, top_k=len(rows))
    if not hits or hits[0]["video_id"] != video_id or hits[0]["text"] != text \
            or hits[0]["jump_to"] != {"start_ms": start_ms, "end_ms": end_ms}:
        raise AssertionError(f"worker: search for the last chunk's text gave {hits[:2]}")
    log(f"worker: semantic_indexing completed on the card: {len(rows)} chunks; search "
        f"finds the last one first (score {hits[0]['score']:.4f}) at {hits[0]['jump_to']}")
    return {"chunks": len(rows), "top_score": hits[0]["score"]}


def write_minilm_checkpoint(cache: str, seed: int = 0) -> None:
    """A seeded full-width MiniLM as `minilm-l6/pytorch_model.bin` in the
    sentence-transformers layout ('0.auto_model.' prefix). Its token
    embeddings are scaled by 100, so that its embeddings tell texts apart:
    the 0.05-scaled random init maps every text to cosine ~0.998 of every
    other."""
    import torch

    from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, init_minilm

    sd = init_minilm(MiniLMConfig(), torch.Generator().manual_seed(seed)).state_dict()
    sd["embeddings.word_embeddings.weight"] = sd["embeddings.word_embeddings.weight"] * 100
    os.makedirs(os.path.join(cache, "minilm-l6"), exist_ok=True)
    torch.save({"0.auto_model." + k: v for k, v in sd.items()},
               os.path.join(cache, "minilm-l6", "pytorch_model.bin"))


def write_cross_encoder_checkpoint(cache: str, words: list[str]) -> None:
    """A seeded full-width cross-encoder in HF BertForSequenceClassification
    layout, and a vocab.txt of `words` in this cache of its own (a vocab in
    a cache changes the MiniLM tokenizer too)."""
    import torch

    from eioku_tpu_torch.models.embed.cross_encoder import (
        CrossEncoderConfig,
        init_cross_encoder,
    )

    sd = init_cross_encoder(CrossEncoderConfig(), torch.Generator().manual_seed(5)).state_dict()
    sd["embeddings.word_embeddings.weight"] = sd["embeddings.word_embeddings.weight"] * 100
    os.makedirs(os.path.join(cache, "msmarco-minilm-l6"), exist_ok=True)
    torch.save({("" if k.startswith("classifier") else "bert.") + k: v for k, v in sd.items()},
               os.path.join(cache, "msmarco-minilm-l6", "pytorch_model.bin"))
    with open(os.path.join(cache, "vocab.txt"), "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + words) + "\n")


def _ids_with_lengths(b: int, s: int, lengths, vocab: int, seed: int):
    """Seeded token ids [b, s] and a mask with the given valid lengths."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (b, s), generator=g)
    mask = (torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]).to(torch.int32)
    return ids * mask, mask


def _minilm_card_vs_cpu(cpu, card, ids, mask, dev, label: str) -> dict:
    """fp32 card (TF32 off) within MINILM_TOL of the CPU; bf16 card within
    cosine MINILM_COS of the CPU. Counts K3's launches of each card call."""
    from dataclasses import replace

    import torch

    from eioku_tpu_torch.models.embed.minilm import minilm_embed
    from eioku_tpu_torch.ops import _cuda

    fp32 = replace(card.cfg, compute_dtype="float32")
    want = minilm_embed(cpu, ids, mask)
    out = {}
    for name, cfg in (("float32", fp32), ("bfloat16", replace(fp32, compute_dtype="bfloat16"))):
        card.cfg = cfg
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        got = minilm_embed(card, ids.to(dev), mask.to(dev))
        torch.cuda.synchronize()
        out[f"k3_launches_{name}"] = _cuda.launch_counts()["flash_attention"]
        got = got.cpu()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"MiniLM {label} {name}: non-finite embeddings")
        if name == "float32":
            out["fp32_max_abs_err"] = float((got - want).abs().max())
        else:
            out["bf16_min_cosine"] = float((got * want).sum(-1).min())
    log(f"MiniLM {label}: fp32 card vs CPU max abs err {out['fp32_max_abs_err']:.3e} "
        f"(tolerance {MINILM_TOL}), bf16 card vs fp32 CPU min cosine "
        f"{out['bf16_min_cosine']:.6f} (at least {MINILM_COS}); K3 launches "
        f"{out['k3_launches_float32']} (fp32), {out['k3_launches_bfloat16']} (bf16)")
    if not out["fp32_max_abs_err"] <= MINILM_TOL or not out["bf16_min_cosine"] >= MINILM_COS:
        raise AssertionError(f"MiniLM {label}: card and CPU disagree: {out}")
    return out


def _p50_ms(times: list[float]) -> float:
    return sorted(times)[len(times) // 2] * 1e3


def _embedding_like_corpus(n: int, dim: int, n_queries: int, seed: int = 0):
    """bench.py:1024-1043: 300 topic clusters with spread 0.6, queries =
    corpus point + noise 0.4; here L2-normalised, as the index stores them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((300, dim)).astype(np.float32)
    assign = rng.integers(0, 300, n)
    corpus = centers[assign] + 0.6 * rng.standard_normal((n, dim)).astype(np.float32)
    qi = rng.integers(0, n, n_queries)
    queries = corpus[qi] + 0.4 * rng.standard_normal((n_queries, dim)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return corpus, queries


def phase_semantic_models(dev) -> dict:
    """5.1 MiniLM at full width card vs CPU at [32, 256]; 5.2 the S = 512
    route: K3 six times per call, card vs CPU, ms per call."""
    import torch

    from eioku_tpu_torch.models.embed.minilm import MiniLMConfig, init_minilm, minilm_embed

    cfg = MiniLMConfig()
    cpu = init_minilm(cfg, torch.Generator().manual_seed(0))
    card = init_minilm(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(3)
    b, s = MINILM_CHECK
    lengths = [s] + [int(x) for x in rng.integers(2, s, b - 1)]
    short = _minilm_card_vs_cpu(cpu, card, *_ids_with_lengths(b, s, lengths, cfg.vocab_size, 1),
                                dev, f"[{b}, {s}]")
    if short["k3_launches_float32"] or short["k3_launches_bfloat16"]:
        raise AssertionError("MiniLM at S = 256 must take the plain route, not K3")
    b, s = MINILM_LONG
    ids, mask = _ids_with_lengths(b, s, MINILM_LONG_LENGTHS, cfg.vocab_size, 2)
    long = _minilm_card_vs_cpu(cpu, card, ids, mask, dev, f"[{b}, {s}] lengths "
                               f"{list(MINILM_LONG_LENGTHS)}")
    if long["k3_launches_float32"] != cfg.n_layers or long["k3_launches_bfloat16"] != cfg.n_layers:
        raise AssertionError(f"MiniLM at S = 512 launched K3 {long} times, not once per layer")
    ids, mask = ids.to(dev), mask.to(dev)  # card.cfg is bf16 after the check
    ms = cuda_ms(lambda: minilm_embed(card, ids, mask), iters=20, warmup=3)
    log(f"MiniLM [{b}, {s}] bf16 through K3: {ms:.4f} ms per call")
    return {"s256": short, "s512": long, "s512_bf16_ms_per_call": ms}


def phase_semantic_index(dev, root: str) -> dict:
    """5.3 bench.py's search corpus through SemanticIndex.index_video on the
    card, embed-only throughput, and search p50 on the IVF route."""
    import uuid

    import torch

    from eioku_tpu_torch.api.app import build_context
    from eioku_tpu_torch.config.settings import AppConfig
    from eioku_tpu_torch.domain.models import Video
    from eioku_tpu_torch.index.semantic import SemanticIndex
    from eioku_tpu_torch.models.embed.minilm import minilm_embed
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.utils.device import compute_dtype_name
    from eioku_tpu_torch.utils.hashing import compute_config_hash
    from eioku_tpu_torch.workers.task_handler import build_envelopes

    cache = os.path.join(root, "models")
    write_minilm_checkpoint(cache)
    ctx = build_context(AppConfig(
        scan_paths=[], database_url=f"sqlite:///{root}/s.db", auto_discover=False,
        semantic_search=False, visual_search=False, model_cache_dir=cache,
        index_dir=os.path.join(root, "index")))
    index = SemanticIndex(ctx, batch_size=EMBED_BATCH, device=dev)  # bench.py's batch
    video = Video(path=os.path.join(root, "corpus.mp4"), file_hash="bench",
                  duration_ms=3_600_000)
    ctx.videos.save(video)
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    results = []
    for i in range(SEM_SEGMENTS):
        s_ms, e_ms = i * 4000, (i + 1) * 4000
        results.append({"payload": {"text": " ".join(rng.choice(SEM_WORDS, 10)),
                                    "language": "en", "start_ms": s_ms, "end_ms": e_ms,
                                    "confidence": 0.9},
                        "span_start_ms": s_ms, "span_end_ms": e_ms})
    ctx.artifacts.batch_create(build_envelopes(
        results, video_id=video.id, artifact_type="transcript.segment",
        run_id=str(uuid.uuid4()), producer="smoke", producer_version="0",
        model_profile="balanced", config_hash=compute_config_hash({}), input_hash="smoke"))
    insert_s = time.perf_counter() - t
    t = time.perf_counter()
    index._ensure_model()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    if not index.pretrained or index._cfg.compute_dtype != compute_dtype_name(dev):
        raise AssertionError("the index did not load the written checkpoint in the "
                             "device's compute type (bf16 on the card)")
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    chunks = index.index_video(video.id, {"chunk_chars": 60, "overlap_chars": 0,
                                          "index_ocr": False})
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t
    k3_indexing = _cuda.launch_counts()["flash_attention"]
    rows = ctx.db.scalar("SELECT COUNT(*) FROM embedding_chunks")
    log(f"semantic index: {SEM_SEGMENTS} segments inserted in {insert_s:.2f} s, model "
        f"loaded in {load_s:.2f} s; index_video: {chunks} chunks in {index_s:.3f} s "
        f"({chunks / index_s:.1f} chunks/s), {rows} embedding_chunks rows, "
        f"K3 launches {k3_indexing}")
    if rows != chunks or chunks < index.IVF_THRESHOLD or k3_indexing:
        raise AssertionError(f"indexing: {chunks} chunks, {rows} rows, K3 {k3_indexing}")

    # embed only: bench.py's batch 256 x S 256 bf16, all tokens valid
    model = index._model
    g = torch.Generator().manual_seed(0)
    inputs = [torch.randint(0, model.cfg.vocab_size, (EMBED_BATCH, EMBED_SEQ),
                            generator=g).to(dev) for _ in range(EMBED_BATCHES)]
    mask = torch.ones((EMBED_BATCH, EMBED_SEQ), dtype=torch.int32, device=dev)
    for x in inputs[:2]:
        minilm_embed(model, x, mask)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for x in inputs[2:]:
        out = minilm_embed(model, x, mask)
    float(out.sum())
    embed_cps = (EMBED_BATCHES - 2) * EMBED_BATCH / (time.perf_counter() - t)
    log(f"embed only, batch {EMBED_BATCH} x S {EMBED_SEQ} bf16: {embed_cps:.1f} chunks/s")

    # search: the IVF index is built by the first search; build it apart
    corpus = index._corpus()
    t = time.perf_counter()
    ivf = index._ivf(corpus)
    torch.cuda.synchronize()
    ivf_build_s = time.perf_counter() - t
    if ivf is None:
        raise AssertionError("the corpus did not take the IVF route")
    texts = [r[0] for r in ctx.db.query(
        "SELECT text FROM embedding_chunks ORDER BY slot")]
    t = time.perf_counter()
    index._tokenizer.encode_batch(texts)  # the host's share of index_video
    tokenize_s = time.perf_counter() - t
    queries = [texts[int(i)] for i in rng.integers(0, len(texts), N_QUERIES)]
    embed_times, times, first = [], [], 0
    for q in queries:
        t = time.perf_counter()
        index.embed_texts([q])  # a batch padded to 256 rows, as search embeds it
        embed_times.append(time.perf_counter() - t)
        t = time.perf_counter()
        hits = index.search(q, top_k=10)
        times.append(time.perf_counter() - t)
        if len(hits) != 10 or not all(math.isfinite(h["score"]) for h in hits) \
                or hits[0]["video_id"] != video.id:
            raise AssertionError(f"search {q!r}: {hits[:2]}")
        if q not in [h["text"] for h in hits]:
            raise AssertionError(f"search {q!r}: its own chunk is not among the hits")
        first += hits[0]["text"] == q
    p50, embed_p50 = _p50_ms(times), _p50_ms(embed_times)
    log(f"tokenizing the {len(texts)} chunks alone: {tokenize_s:.3f} s; embedding "
        f"them at the embed-only rate: {len(texts) / embed_cps:.3f} s")
    log(f"search on the IVF route ({ivf.k} clusters, built in {ivf_build_s:.3f} s): "
        f"p50 {p50:.2f} ms over {N_QUERIES} queries (top 10, query embed and row "
        f"join included; the query's embedding alone p50 {embed_p50:.2f} ms); the "
        f"query's own chunk first in {first}/{N_QUERIES}")
    return {"segments": SEM_SEGMENTS, "chunks": chunks, "model_load_s": load_s,
            "index_video_s": index_s, "index_chunks_per_s": chunks / index_s,
            "tokenize_s": tokenize_s, "k3_launches_indexing": k3_indexing,
            "embed_only_chunks_per_s": embed_cps, "ivf_clusters": ivf.k,
            "ivf_build_s": ivf_build_s, "search_p50_ms": p50,
            "query_embed_p50_ms": embed_p50, "search_own_chunk_first": first,
            "texts": texts}


def phase_retrieval(dev) -> dict:
    """5.4 _topk_cosine and the IVF index at scale on bench.py's clustered
    corpus; card vs CPU top-10 at N = 10,000."""
    import torch

    from eioku_tpu_torch.index.ivf import IvfIndex, top_k
    from eioku_tpu_torch.index.semantic import _topk_cosine

    out = {}
    for n in RETRIEVAL_SIZES:
        v, queries = _embedding_like_corpus(n, 384, N_QUERIES)
        corpus = torch.from_numpy(v.astype(np.float16)).to(dev)
        qs = [torch.from_numpy(q).to(dev) for q in queries]
        _topk_cosine(corpus, qs[0], 10)
        times = []
        for q in qs:
            t = time.perf_counter()
            scores, idx = _topk_cosine(corpus, q, 10)
            float(scores.sum()) + int(idx[0])  # completion and transfer
            times.append(time.perf_counter() - t)
        r = {"topk_cosine_p50_ms": _p50_ms(times)}
        if n == RETRIEVAL_SIZES[0]:
            cpu_corpus, checked = corpus.cpu(), 0
            for q in queries:
                want_s, want_i = _topk_cosine(cpu_corpus, torch.from_numpy(q), 11)
                got_s, got_i = _topk_cosine(corpus, torch.from_numpy(q).to(dev), 11)
                if float(want_s[9] - want_s[10]) > GAP_TOL:
                    checked += 1
                    if not torch.equal(got_i[:10].cpu(), want_i[:10]):
                        raise AssertionError(f"top-10 slots differ card vs CPU at N = {n}")
            if not checked:
                raise AssertionError("no query had a clear 10th rank to compare")
            r["card_vs_cpu_queries_compared"] = checked
        else:
            vf = torch.from_numpy(v).to(dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            ivf = IvfIndex.build(vf)
            torch.cuda.synchronize()
            r["ivf_build_s"] = time.perf_counter() - t
            r["ivf_clusters"] = ivf.k
            r["ivf_block_bytes"] = ivf.blocks.numel() * ivf.blocks.element_size()
            n_probe = max(ivf.k // 8, 1)
            times, hits = [], 0
            for q in queries:
                t = time.perf_counter()
                _, slots = ivf.search(q, top_k=10)
                times.append(time.perf_counter() - t)
                exact = top_k(vf @ torch.from_numpy(q).to(dev), 10)[1].cpu().numpy()
                hits += len(set(exact.tolist()) & {int(x) for x in slots if x >= 0})
            r.update({"ivf_search_p50_ms": _p50_ms(times), "ivf_n_probe": n_probe,
                      "ivf_recall_at_10": hits / (10 * len(queries))})
            del vf, ivf
        log(f"retrieval N = {n}: {r}")
        out[str(n)] = r
        del corpus
    return out


def phase_rerank(dev, root: str, texts: list[str]) -> dict:
    """5.5 the cross-encoder reranker on a 64-candidate bucket, card vs CPU."""
    from dataclasses import replace

    import torch

    from eioku_tpu_torch.index.rerank import Reranker
    from eioku_tpu_torch.models.embed.cross_encoder import cross_encoder_score

    cache = os.path.join(root, "rerank_models")
    write_cross_encoder_checkpoint(cache, list(SEM_WORDS))
    card, cpu = Reranker(cache, device=dev), Reranker(cache, device="cpu")
    if not card.available or not cpu.available:
        raise AssertionError("the reranker did not load its written checkpoint and vocab")
    results = [{"text": t, "i": i} for i, t in enumerate(texts[:64])]
    query = "beach sunset dog"
    got = {r["i"]: r["rerank_score"] for r in card.rerank(query, results, 64)}
    want = {r["i"]: r["rerank_score"] for r in cpu.rerank(query, results, 64)}
    bf16_err = max(abs(got[i] - want[i]) for i in want)
    spread = max(want.values()) - min(want.values())
    # the same pairs through the card's model at fp32 (TF32 off)
    model, tok, _ = card._model
    ids, types, mask = (torch.from_numpy(a) for a in tok.encode_pairs(
        query, [r["text"] for r in results]))
    bf16_cfg = model.cfg
    model.cfg = replace(bf16_cfg, compute_dtype="float32")
    try:
        fp32 = cross_encoder_score(model, ids.to(dev), types.to(dev), mask.to(dev)).cpu()
    finally:
        model.cfg = bf16_cfg
    ref = cross_encoder_score(cpu._model[0], ids, types, mask)
    fp32_err = float((fp32 - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    for _ in range(2):
        card.rerank(query, results, 64)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        card.rerank(query, results, 64)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / 10 * 1e3
    log(f"rerank 64 candidates: bf16 card vs fp32 CPU max logit err {bf16_err:.3e} "
        f"(tolerance {RERANK_TOL}; logits spread {spread:.3f}); fp32 card vs CPU "
        f"{fp32_err:.3e} (tolerance {MINILM_TOL} x {scale:.2f}); {ms:.2f} ms per rerank")
    if not bf16_err <= RERANK_TOL or not fp32_err <= MINILM_TOL * scale:
        raise AssertionError("rerank logits differ card vs CPU")
    return {"candidates": 64, "bf16_max_logit_err": bf16_err, "logit_spread": spread,
            "fp32_max_logit_err": fp32_err, "ms_per_rerank": ms}


def phase_semantic(dev, workdir: str, card: str) -> dict:
    """Phase 5: the semantic layer on the card."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    root = os.path.join(workdir, "semantic")
    os.makedirs(root)
    models = phase_semantic_models(dev)
    index = phase_semantic_index(dev, root)
    retrieval = phase_retrieval(dev)
    rerank = phase_rerank(dev, root, index.pop("texts"))
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"semantic phase peak device memory {peak:.1f} MiB ({card})")
    return {"models": models, "index": index, "retrieval": retrieval, "rerank": rerank,
            "peak_mib": peak, "card": card}


def _peak_run(fn, *args):
    """(fn(*args), wall s, peak device MiB), the device synchronised around
    it and its peak reset before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated() / 2**20


def _ocr_models_card_vs_cpu(clip: str) -> dict:
    """CRAFT on one 384x640 frame of the clip and CRNN at every bucket width,
    full width, fp32 on the card (TF32 off) against the CPU: each within
    MODEL_TOL of its largest |value|."""
    import copy

    import torch

    from eioku_tpu_torch.ml import ocr_task, video_io
    from eioku_tpu_torch.models.ocr.craft import CRAFT
    from eioku_tpu_torch.models.ocr.crnn import CRNN

    batch = next(iter(video_io.iter_frame_batches(
        clip, batch_size=1, frame_interval_s=7.0,
        resize_hw=(ocr_task.DETECT_H, ocr_task.DETECT_W), fast_level=0)))
    rgb = torch.from_numpy(batch.frames[:1]).float() / 255.0
    x = ((rgb - torch.from_numpy(ocr_task._MEAN)) / torch.from_numpy(ocr_task._STD)) \
        .permute(0, 3, 1, 2).contiguous()
    gen = torch.Generator().manual_seed(3)
    cases = [("craft 384x640", CRAFT(generator=torch.Generator().manual_seed(0)).eval(), x)]
    crnn = CRNN(generator=torch.Generator().manual_seed(0)).eval()
    for w in ocr_task.CROP_WIDTHS:
        crops = torch.rand((8, 1, 32, w), generator=gen) * 2 - 1
        crops[1::2, :, :, w // 2:] = -1.0  # the -1.0 padding of shorter crops
        cases.append((f"crnn W={w}", crnn, crops))
    errs = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card_models = {}
        for name, model, inp in cases:
            card = card_models.setdefault(id(model), copy.deepcopy(model).cuda())
            with torch.no_grad():
                ref = model(inp)
                got = card(inp.cuda()).cpu()
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            log(f"{name} fp32 card vs CPU: max abs err {err:.3e} (max |value| {scale:.3e})")
            if not err <= MODEL_TOL * max(scale, 1.0):
                raise AssertionError(f"{name}: card and CPU differ by {err} (scale {scale})")
            errs[name] = err
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return errs


def phase_ocr(dev, workdir: str, card: str) -> dict:
    """OCR at full width with random weights (seed 0): the models card vs
    CPU; the standalone ocr task on the clip (box extraction timed apart);
    visual_analysis with all five sub-tasks at their defaults (K1 once, K2
    twice); and a run whose OCR frames are the standalone task's frames,
    whose OCR rows must equal the standalone task's."""
    import torch

    from eioku_tpu_torch.ml import ocr_task
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda

    clip = os.path.join(workdir, "clip.mp4")
    models = _ocr_models_card_vs_cpu(clip)
    engine = InferenceEngine(model_cache_dir=os.path.join(workdir, "models"), device=dev)
    stages = {"extract_quads": {"s": 0.0, "calls": 0, "out": 0},
              "recognize_crops": {"s": 0.0, "calls": 0, "out": 0}}
    originals = {name: getattr(ocr_task, name) for name in stages}

    def timed(name):
        def run(*a, **kw):
            t = time.perf_counter()
            out = originals[name](*a, **kw)
            stages[name]["s"] += time.perf_counter() - t
            stages[name]["calls"] += 1
            stages[name]["out"] += len(out)
            return out
        return run

    engine.run_task("ocr", clip, {"frame_interval_s": 30.0})  # warm-up: models, cuDNN
    for name in stages:
        setattr(ocr_task, name, timed(name))
    try:
        rows, wall, peak = _peak_run(engine.run_task, "ocr", clip, {})
    finally:
        for name, fn in originals.items():
            setattr(ocr_task, name, fn)
    extraction = {"s": stages["extract_quads"]["s"], "calls": stages["extract_quads"]["calls"],
                  "quads": stages["extract_quads"]["out"]}
    recognition = stages["recognize_crops"]
    frames = _grid_frames(2.0, sample_fps=1 / 2.0)
    if extraction["calls"] != frames or not rows:
        raise AssertionError(f"ocr task: {extraction['calls']} frames searched for text "
                             f"(expected {frames}), {len(rows)} rows")
    if not all(math.isfinite(r["payload"]["confidence"]) and r["payload"]["text"]
               for r in rows):
        raise AssertionError("ocr task: a row without text or with a non-finite confidence")
    log(f"ocr task: {wall:.3f} s wall, {CLIP_SECONDS / wall:.2f} video-s/s, peak "
        f"{peak:.1f} MiB, {len(rows)} rows from {extraction['quads']} quads in "
        f"{frames} frames; host box extraction {extraction['s']:.3f} s; recognition "
        f"(host crop batches, CRNN, CTC decode) {recognition['s']:.3f} s in "
        f"{recognition['calls']} calls ({card})")
    standalone = {"wall_s": wall, "video_s_per_s": CLIP_SECONDS / wall, "peak_mib": peak,
                  "rows": len(rows), "frames": frames, "quads": extraction["quads"],
                  "box_extraction_s": extraction["s"], "recognition_s": recognition["s"],
                  "recognition_calls": recognition["calls"]}

    config = {**VISUAL_CONFIG, "ocr": {}}
    engine.run_task("visual_analysis", clip, config)  # warm-up
    _cuda.reset_launch_counts()
    out, wall, peak = _peak_run(engine.run_task, "visual_analysis", clip, config)
    launches = _cuda.launch_counts()
    log(f"visual_analysis with OCR: {wall:.3f} s wall, {CLIP_SECONDS / wall:.2f} "
        f"video-s/s, peak {peak:.1f} MiB, rows { {k: len(v) for k, v in out.items()} }; "
        f"launches {launches} ({card})")
    if set(out) != set(config) or not out["ocr"]:
        raise AssertionError(f"visual_analysis with OCR returned {sorted(out)}, "
                             f"{len(out.get('ocr', []))} OCR rows")
    if launches["scene_diff"] != 1 or launches["nms"] != 2:
        raise AssertionError(f"visual_analysis with OCR: expected K1 x1 and K2 x2, "
                             f"got {launches}")
    fold = {"wall_s": wall, "video_s_per_s": CLIP_SECONDS / wall, "peak_mib": peak,
            "rows": {k: len(v) for k, v in out.items()}, "launches": launches}

    # the same frames as the standalone task: decode at full size (the OCR
    # consumer then resizes the source frame to 384x640 with INTER_AREA, as
    # the task's cv2 decode does; the native decoder, where it builds, has
    # its own filter, so both decode with cv2 here) and a scene cadence of
    # 2 fps, whose grid holds the task's 2 s grid (step 60 at 30 fps)
    same = {**config, "detector_size": max(CLIP_W, CLIP_H),
            "scene_detection": {"sample_fps": 2.0}}
    native = os.environ.get("EIOKU_NATIVE_DECODE")
    os.environ["EIOKU_NATIVE_DECODE"] = "0"
    try:
        rows = engine.run_task("ocr", clip, {})
        fold_rows = engine.run_task("visual_analysis", clip, same)["ocr"]
    finally:
        if native is None:
            del os.environ["EIOKU_NATIVE_DECODE"]
        else:
            os.environ["EIOKU_NATIVE_DECODE"] = native
    if fold_rows != rows or not rows:
        differ = sum(a != b for a, b in zip(fold_rows, rows)) + abs(len(fold_rows) - len(rows))
        raise AssertionError(f"the fold's OCR rows on the task's frames differ from the "
                             f"task's in {differ} rows ({len(fold_rows)} vs {len(rows)})")
    log(f"visual_analysis on the ocr task's frames: OCR rows equal the task's "
        f"({len(rows)} rows)")
    return {"models_max_abs_err": models, "task": standalone, "visual_analysis": fold,
            "fold_rows_equal_task_rows": len(rows), "card": card}


def _clip_towers_card_vs_cpu(dev) -> dict:
    """Both ViT-B/32 towers at full width, random weights (seed 0), fp32 on
    the card (TF32 off) against the CPU: within MODEL_TOL."""
    import copy

    import torch

    from eioku_tpu_torch.models.clip.model import (
        ClipConfig,
        clip_encode_image,
        clip_encode_text,
        init_clip,
    )
    from eioku_tpu_torch.models.clip.tokenizer import FallbackClipTokenizer

    cfg = ClipConfig()
    cpu = init_clip(cfg, torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    imgs = torch.randn((4, cfg.image_size, cfg.image_size, 3),
                       generator=torch.Generator().manual_seed(4))
    ids = torch.from_numpy(np.asarray(FallbackClipTokenizer(cfg.vocab_size).encode_batch(
        ["a red car at night", "a dog on the beach", "", "whiteboard"])))
    errs = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, fn, x in (("image", clip_encode_image, imgs), ("text", clip_encode_text, ids)):
            ref = fn(cpu, x)
            got = fn(card, x.to(dev)).cpu()
            errs[name] = float((got - ref).abs().max())
            log(f"clip {name} tower fp32 card vs CPU: max abs err {errs[name]:.3e}")
            if not errs[name] <= MODEL_TOL:
                raise AssertionError(f"clip {name} tower: card and CPU differ by {errs[name]}")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return errs


def phase_clip(dev, workdir: str, card: str) -> dict:
    """CLIP ViT-B/32 and the visual index on the card: towers card vs CPU;
    embed_frames over CLIP_FRAMES frames at batch 16; the query embedding;
    VisualIndex.index_video (stride keyframes, seek-decoded), search and
    similar on the clip."""
    import torch

    from eioku_tpu_torch.api.app import build_context
    from eioku_tpu_torch.config.settings import AppConfig
    from eioku_tpu_torch.domain.models import Video
    from eioku_tpu_torch.models.clip.model import clip_encode_image, preprocess_images

    towers = _clip_towers_card_vs_cpu(dev)
    root = os.path.join(workdir, "clip_index")
    os.makedirs(root)
    clip = os.path.join(workdir, "clip.mp4")
    ctx = build_context(AppConfig(scan_paths=[], database_url=f"sqlite:///{root}/v.db",
                                  semantic_search=False, visual_search=True,
                                  model_cache_dir=root), device=dev)
    index = ctx.extra["visual_index"]
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 255, (CLIP_H, CLIP_W, 3), np.uint8)
              for _ in range(CLIP_FRAMES)]
    index.embed_frames(frames[:16])  # warm-up: the model on the card
    vecs, embed_s, peak = _peak_run(index.embed_frames, frames)
    # its two halves: the host's resize and crop, then the image tower alone
    pre, preprocess_s, _ = _peak_run(preprocess_images, frames, index._cfg)
    batches = [torch.from_numpy(pre[i:i + 16]).to(dev) for i in range(0, CLIP_FRAMES, 16)]
    _, tower_s, _ = _peak_run(lambda: [clip_encode_image(index._model, b) for b in batches])
    norms = np.linalg.norm(vecs, axis=1)
    if vecs.shape != (CLIP_FRAMES, 512) or np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"embed_frames: shape {vecs.shape}, norms off 1 by "
                             f"{np.abs(norms - 1).max()}")
    times = []
    for i in range(N_QUERIES):
        _, t, _ = _peak_run(index.embed_texts, [f"{SEM_WORDS[i]} at night"])
        times.append(t)
    query_ms = _p50_ms(times)
    video = Video(path=clip, file_hash="clip", duration_ms=CLIP_SECONDS * 1000)
    ctx.videos.save(video)
    n, index_s, _ = _peak_run(index.index_video, video.id, {})
    hits, search_s, _ = _peak_run(index.search, "a red frame", 10)
    similar = index.similar(video.id, 15000, top_k=10)
    want_stamps = list(range(5000, CLIP_SECONDS * 1000, 10000))  # 10 s stride
    scores = [h["score"] for h in hits]
    if n != len(want_stamps) or sorted(h["ts_ms"] for h in hits) != want_stamps \
            or scores != sorted(scores, reverse=True) \
            or not all(math.isfinite(x) for x in scores):
        raise AssertionError(f"visual index: {n} keyframes, search hits {hits}")
    if len(similar) != n - 1 or 15000 in {h["ts_ms"] for h in similar}:
        raise AssertionError(f"similar: {similar}")
    log(f"clip: embed_frames {CLIP_FRAMES} frames at batch 16 in {embed_s:.3f} s "
        f"({CLIP_FRAMES / embed_s:.1f} frames/s, host preprocessing included; the "
        f"preprocessing alone {preprocess_s:.3f} s, the image tower alone "
        f"{tower_s:.3f} s = {CLIP_FRAMES / tower_s:.1f} frames/s), peak "
        f"{peak:.1f} MiB; query embedding p50 {query_ms:.3f} ms; index_video {n} "
        f"keyframes in {index_s:.3f} s; search {search_s * 1e3:.3f} ms ({card})")
    return {"towers_max_abs_err": towers, "embed_frames_per_s": CLIP_FRAMES / embed_s,
            "embed_s": embed_s, "preprocess_s": preprocess_s, "tower_s": tower_s,
            "tower_frames_per_s": CLIP_FRAMES / tower_s, "peak_mib": peak, "query_ms_p50": query_ms,
            "index_video_s": index_s, "keyframes": n, "search_ms": search_s * 1e3,
            "card": card}


# -- phase 8: the audio slice ---------------------------------------------------------


def _bytes_of(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def phase_int8_linears(dev, card: str) -> dict:
    """8.1 QuantLinear on the card against the CPU at turbo's widths, fp32
    activations: w_q, the int8 activations and the int32 accumulators equal,
    outputs within INT8_TOL of their largest |value|; then ms per call at
    the decoder's rows, bf16 activations, beside the bf16 Linear."""
    import torch

    from eioku_tpu_torch.models.layers import Linear, QuantLinear
    from eioku_tpu_torch.ops.quant import int_mm, quant_act

    out = {}
    g = torch.Generator().manual_seed(0)
    for k, n in INT8_WIDTHS:
        lin = Linear(k, n)
        with torch.no_grad():
            lin.weight.copy_(torch.randn((n, k), generator=g) * 0.02)
            lin.bias.copy_(torch.randn(n, generator=g) * 0.01)
        q_cpu = QuantLinear.from_linear(lin)
        q_card = QuantLinear.from_linear(lin.to(dev))
        if not torch.equal(q_card.w_q.cpu(), q_cpu.w_q) or \
                not torch.equal(q_card.w_s.cpu(), q_cpu.w_s):
            raise AssertionError(f"int8 {k}->{n}: w_q or w_s differ card vs CPU")
        errs = {}
        for rows in INT8_ROWS:
            x = torch.randn((rows, k), generator=g)
            xq, sx = quant_act(x)
            xq_d, sx_d = quant_act(x.to(dev))
            if not torch.equal(xq_d.cpu(), xq) or not torch.equal(sx_d.cpu(), sx):
                raise AssertionError(f"int8 {k}->{n} rows {rows}: int8 activations differ")
            if not torch.equal(int_mm(xq_d, q_card.w_q).cpu(), int_mm(xq, q_cpu.w_q)):
                raise AssertionError(f"int8 {k}->{n} rows {rows}: int32 accumulators differ")
            want = q_cpu(x)
            err = float((q_card(x.to(dev)).cpu() - want).abs().max())
            scale = float(want.abs().max())
            if not err <= INT8_TOL * scale:
                raise AssertionError(f"int8 {k}->{n} rows {rows}: {err} vs scale {scale}")
            errs[rows] = err / scale
        xb = torch.randn((INT8_ROWS[0], k), generator=g).to(dev, torch.bfloat16)
        lin_b = lin.to(torch.bfloat16)
        q_ms = cuda_ms(q_card, args=((xb,),))
        b_ms = cuda_ms(lin_b, args=((xb,),))
        out[f"{k}x{n}"] = {"max_rel_err": errs, "int8_ms": q_ms, "bf16_ms": b_ms}
        log(f"QuantLinear {k}->{n}: card equals CPU (w_q, activations, int32); "
            f"outputs within {max(errs.values()):.2e} of max |value|; at "
            f"{INT8_ROWS[0]} rows bf16: int8 {q_ms:.4f} ms, bf16 Linear {b_ms:.4f} ms "
            f"per call ({card})")
    return out


def phase_int8_transcription(dev, wav: str, card: str) -> dict:
    """8.1 large-v3-turbo at full width (random weights) through run_task:
    int8 (its default), then bf16; each loaded fresh (a warm-up call that
    loads, casts and quantizes), then a measured call: wall, audio-s/s,
    peak MiB, weight bytes, K3's launches (32 per encoder call)."""
    import torch

    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.layers import QuantLinear
    from eioku_tpu_torch.ops import _cuda

    from eioku_tpu_torch.models.whisper.model import WhisperConfig

    layers = WhisperConfig("large-v3-turbo").n_enc_layers
    engine = InferenceEngine(device=dev)
    out = {}
    for name, cfg in (("int8", TURBO_CONFIG),
                      ("bfloat16", {**TURBO_CONFIG, "compute_dtype": "bfloat16"})):
        transcribe._load_model.cache_clear()
        torch.cuda.empty_cache()
        _, load_s, _ = _peak_run(engine.run_task, "transcription", wav, cfg)
        model = transcribe._load_model("large-v3-turbo", None, name if name == "int8"
                                       else "bfloat16", True, dev)[0]
        quantized = isinstance(model.decoder.blocks[0].mlp[0], QuantLinear)
        if quantized != (name == "int8"):
            raise AssertionError(f"turbo {name}: quantized linears {quantized}")
        with _counting(transcribe, "whisper_encode") as enc:
            _cuda.reset_launch_counts()
            rows, wall, peak = _peak_run(engine.run_task, "transcription", wav, cfg)
            k3 = _cuda.launch_counts()["flash_attention"]
        if not enc or k3 != layers * len(enc) or rows != []:
            raise AssertionError(f"turbo {name}: K3 {k3} for {len(enc)} encoder calls, "
                                 f"{len(rows)} rows (random weights emit none)")
        weights = _bytes_of(model)
        out[name] = {"wall_s": wall, "audio_s_per_s": AUDIO_SECONDS / wall,
                     "peak_mib": peak, "weight_mib": weights / 2**20,
                     "first_call_s": load_s, "k3_launches": k3, "encoder_calls": len(enc)}
        log(f"transcription large-v3-turbo {name}: {wall:.3f} s wall, "
            f"{AUDIO_SECONDS / wall:.2f} audio-s/s, peak {peak:.1f} MiB, weights "
            f"{weights / 2**20:.1f} MiB; first call (load{', quantize' if quantized else ''}) "
            f"{load_s:.3f} s; K3 {k3} launches in {len(enc)} encoder calls ({card})")
    transcribe._load_model.cache_clear()
    torch.cuda.empty_cache()
    return out


def phase_embed_int8(dev, workdir: str, card: str) -> dict:
    """8.1 SemanticIndex with embed_int8 on phase 5's seeded MiniLM: embed
    only at batch 256 x S 256 beside the bf16 index, in turns (bf16, int8,
    int8, bf16), and the cosine of each int8 embedding to the bf16 one."""
    import torch

    from eioku_tpu_torch.api.app import build_context
    from eioku_tpu_torch.config.settings import AppConfig
    from eioku_tpu_torch.index.semantic import SemanticIndex
    from eioku_tpu_torch.models.embed.minilm import minilm_embed
    from eioku_tpu_torch.models.layers import QuantLinear

    root = os.path.join(workdir, "int8_embed")
    cache = os.path.join(root, "models")
    write_minilm_checkpoint(cache)
    indexes = {}
    for name, int8 in (("bfloat16", False), ("int8", True)):
        ctx = build_context(AppConfig(
            scan_paths=[], database_url=f"sqlite:///{root}/{name}.db", auto_discover=False,
            semantic_search=False, visual_search=False, model_cache_dir=cache,
            index_dir=os.path.join(root, name), embed_int8=int8))
        indexes[name] = SemanticIndex(ctx, batch_size=EMBED_BATCH, device=dev)
        indexes[name]._ensure_model()
    layer = indexes["int8"]._model.encoder.layer[0].attention.self.query
    if not isinstance(layer, QuantLinear) or not indexes["int8"].pretrained:
        raise AssertionError("the int8 index did not quantize the written checkpoint")
    g = torch.Generator().manual_seed(0)
    vocab = indexes["int8"]._cfg.vocab_size
    inputs = [torch.randint(0, vocab, (EMBED_BATCH, EMBED_SEQ), generator=g).to(dev)
              for _ in range(EMBED_BATCHES)]
    mask = torch.ones((EMBED_BATCH, EMBED_SEQ), dtype=torch.int32, device=dev)

    def rate(name: str) -> float:
        model = indexes[name]._model
        for x in inputs[:2]:
            minilm_embed(model, x, mask)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for x in inputs[2:]:
            out = minilm_embed(model, x, mask)
        float(out.sum())
        return (EMBED_BATCHES - 2) * EMBED_BATCH / (time.perf_counter() - t)

    rates = {"bfloat16": [], "int8": []}
    for name in ("bfloat16", "int8", "int8", "bfloat16"):
        rates[name].append(rate(name))
    rng = np.random.default_rng(3)
    texts = [" ".join(rng.choice(SEM_WORDS, 10)) for _ in range(EMBED_BATCH)]
    emb = {name: idx.embed_texts(texts) for name, idx in indexes.items()}
    cos = np.sum(emb["int8"] * emb["bfloat16"], axis=1)
    log(f"embed only, batch {EMBED_BATCH} x S {EMBED_SEQ}: int8 "
        f"{', '.join(f'{r:.1f}' for r in rates['int8'])} chunks/s, bf16 "
        f"{', '.join(f'{r:.1f}' for r in rates['bfloat16'])} chunks/s; int8 vs bf16 "
        f"cosine min {cos.min():.5f} over {len(texts)} texts ({card})")
    if not cos.min() >= EMBED_INT8_COS:
        raise AssertionError(f"int8 embeddings: cosine to bf16 {cos.min()}")
    return {"int8_chunks_per_s": rates["int8"], "bf16_chunks_per_s": rates["bfloat16"],
            "min_cosine_to_bf16": float(cos.min()), "card": card}


def write_whisper_checkpoint(cache: str, variant: str, seed: int, dev) -> int:
    """A seeded full-width tree (random init on the card) saved in bf16 as
    `whisper-{variant}.pt`, OpenAI's names. Returns its bytes."""
    import torch

    from eioku_tpu_torch.models.whisper.model import WhisperConfig, init_whisper

    model = init_whisper(WhisperConfig(variant), torch.Generator(device=dev).manual_seed(seed),
                         dev)
    sd = {k: v.to("cpu", torch.bfloat16) for k, v in model.state_dict().items()}
    del model
    path = os.path.join(cache, f"whisper-{variant}.pt")
    torch.save(sd, path)
    return os.path.getsize(path)


def write_tokenizer_files(cache: str) -> None:
    """A vocab.json of word-start pieces (each id decodes to " w<id>") and a
    merges.txt, so that decoded ids become words."""
    with open(os.path.join(cache, "vocab.json"), "w") as f:
        json.dump({f"Ġw{i}": i for i in range(50257)}, f)
    with open(os.path.join(cache, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nĠ w\n")


def phase_whisper_options(dev, wav: str, workdir: str, card: str) -> dict:
    """8.2 word timestamps, the conditioned decode and speculative decoding
    at full width, through run_task on seeded bf16 checkpoints (written and
    deleted here, timed apart): turbo (int8 by default) for the first two,
    large-v3 drafted by turbo for the third."""
    import shutil

    import torch

    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.whisper.model import WhisperConfig
    from eioku_tpu_torch.ops import _cuda

    cache = os.path.join(workdir, "whisper_ckpt")
    os.makedirs(cache)
    t = time.perf_counter()
    sizes = {v: write_whisper_checkpoint(cache, v, seed, dev)
             for v, seed in (("large-v3-turbo", 1), ("large-v3", 2))}
    write_tokenizer_files(cache)
    write_s = time.perf_counter() - t
    log(f"whisper checkpoints written in {write_s:.2f} s: "
        f"{ {v: round(b / 2**20, 1) for v, b in sizes.items()} } MiB")
    engine = InferenceEngine(model_cache_dir=cache, device=dev)
    out = {"checkpoint_write_s": write_s, "checkpoint_mib": {v: b / 2**20 for v, b
                                                              in sizes.items()}}
    try:
        transcribe._load_model.cache_clear()
        turbo = {"model": "large-v3-turbo", **OPTION_CONFIG}
        _, load_s, _ = _peak_run(engine.run_task, "transcription", wav, turbo)
        out["turbo_first_call_s"] = load_s
        rows, wall, peak = _peak_run(engine.run_task, "transcription", wav,
                                     {**turbo, "word_timestamps": True})
        words = [len(r["payload"]["words"]) for r in rows]
        if not rows or not sum(words) or any(
                w["end_ms"] < w["start_ms"] for r in rows for w in r["payload"]["words"]):
            raise AssertionError(f"word_timestamps: {len(rows)} rows, words {words}")
        out["word_timestamps"] = {"wall_s": wall, "rows": len(rows), "peak_mib": peak,
                                  "words_per_row": sum(words) / len(rows)}
        log(f"word_timestamps (turbo int8): {wall:.3f} s wall, {len(rows)} rows, "
            f"{sum(words) / len(rows):.2f} words per row, peak {peak:.1f} MiB ({card})")
        with _counting(transcribe, "whisper_encode") as enc:
            rows, wall, peak = _peak_run(engine.run_task, "transcription", wav,
                                         {**turbo, "condition_on_previous_text": True})
        if not rows or len(enc) != 4:
            raise AssertionError(f"conditioned: {len(rows)} rows, {len(enc)} windows")
        out["condition_on_previous_text"] = {"wall_s": wall, "rows": len(rows),
                                             "serial_windows": len(enc), "peak_mib": peak}
        log(f"condition_on_previous_text (turbo int8): {wall:.3f} s wall, {len(enc)} "
            f"windows decoded serially, {len(rows)} rows ({card})")

        transcribe._load_model.cache_clear()
        torch.cuda.empty_cache()
        spec = {"model": "large-v3", "draft_model": "large-v3-turbo", "beam_size": 1,
                "timestamps": False, "compute_dtype": "bfloat16", **OPTION_CONFIG}
        engine.run_task("transcription", wav, spec)  # loads target and draft
        with _counting(transcribe, "speculative_greedy_decode",
                       lambda out: out[1]) as rates:
            _cuda.reset_launch_counts()
            rows, wall, peak = _peak_run(engine.run_task, "transcription", wav, spec)
            k3 = _cuda.launch_counts()["flash_attention"]
        two_encoders = sum(WhisperConfig(v).n_enc_layers for v in ("large-v3",
                                                                     "large-v3-turbo"))
        if len(rates) != 1 or k3 != two_encoders or not 0.0 <= rates[0] <= 1.0:
            raise AssertionError(f"speculative: {len(rates)} decodes, K3 {k3} "
                                 f"({two_encoders} per batch: two encoders), "
                                 f"rates {rates}")
        out["draft_model"] = {"wall_s": wall, "rows": len(rows), "accept_rate": rates[0],
                              "k3_launches": k3, "peak_mib": peak}
        log(f"draft_model (large-v3 bf16, drafted by turbo bf16, gamma 4): {wall:.3f} s "
            f"wall, accept_rate {rates[0]:.4f}, K3 {k3} launches, {len(rows)} rows, "
            f"peak {peak:.1f} MiB ({card})")
    finally:
        transcribe._load_model.cache_clear()
        shutil.rmtree(cache)
        torch.cuda.empty_cache()
    out["card"] = card
    return out


def phase_vad(dev, wav: str, workdir: str, card: str) -> dict:
    """8.3 a seeded Silero-v5-width VAD (its head scaled and shifted, VAD_HEAD,
    so it passes the loader's behavioural check) exported with the port's
    exporter: vad_probs card vs CPU at fp32 within VAD_TOL at the model's
    init and within VAD_TOL times the head's scale through the checkpoint
    (the scale multiplies the LSTM output's rounding); the activity of
    split_windows on the wav through silero_vad.ckpt equal card vs CPU
    wherever the probabilities keep more than VAD_MARGIN from 0.5."""
    import torch

    from eioku_tpu_torch.ml import audio_io
    from eioku_tpu_torch.models.vad import model as vad
    from eioku_tpu_torch.models.vad import weights

    model = vad.init_vad(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decoder.decoder[2].weight.mul_(VAD_HEAD[0])
        model.decoder.decoder[2].bias.fill_(VAD_HEAD[1])
    cache = os.path.join(workdir, "vad")
    os.makedirs(cache)
    torch.save(weights.export_silero_state_dict(model), os.path.join(cache, "silero_vad.ckpt"))
    audio = audio_io.load_wav(wav)
    padded = np.zeros(-(-len(audio) // (30 * 16000)) * 30 * 16000, np.float32)
    padded[:len(audio)] = audio
    x = torch.from_numpy(padded)[None]
    torch.backends.cudnn.allow_tf32 = False  # fp32 comparison: no TF32 LSTM or matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # the network at its own init, then the checkpoint whose head
        # multiplies the LSTM's output, and so its rounding, by VAD_HEAD[0]
        raw = vad.init_vad(torch.Generator().manual_seed(0))
        raw_err = float(np.abs(vad.vad_probs(raw.to(dev), x.to(dev))[0].cpu().numpy()
                               - vad.vad_probs(raw.cpu(), x)[0].numpy()).max())
        card_model = weights.load_vad(cache, dev)
        cpu_model = weights.load_vad(cache, torch.device("cpu"))
        if card_model is None or cpu_model is None:
            raise AssertionError("the VAD checkpoint failed the loader's check")
        want = vad.vad_probs(cpu_model, x)[0].numpy()
        got = vad.vad_probs(card_model, x.to(dev))[0].cpu().numpy()
        err = float(np.abs(got - want).max())
        if not raw_err <= VAD_TOL or not err <= VAD_TOL * abs(VAD_HEAD[0]):
            raise AssertionError(f"vad_probs card vs CPU: {raw_err} at init, {err} "
                                 f"with the scaled head")
        _, probs_s, _ = _peak_run(lambda: vad.vad_probs(card_model, x.to(dev)).cpu())
        windows, split_s, _ = _peak_run(audio_io.split_windows, audio, 16000, 30.0, True,
                                        cache, dev)
        act = audio_io.compute_vad(audio, model_cache_dir=cache, device=dev)
        act_cpu = audio_io.compute_vad(audio, model_cache_dir=cache, device="cpu")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    frame = 16000 * audio_io.VAD_FRAME_MS // 1000
    chunk_of = np.minimum(np.arange(len(act)) * frame // 512, len(want) - 1)
    clear = np.abs(want[chunk_of] - 0.5) > VAD_MARGIN
    if not np.array_equal(act[clear], act_cpu[clear]):
        raise AssertionError("model VAD activity differs card vs CPU away from 0.5")
    energy = audio_io.split_windows(audio)
    log(f"VAD: vad_probs card vs CPU max abs err {raw_err:.2e} at init, {err:.2e} "
        f"with the head scaled by {VAD_HEAD[0]:g}, over {len(want)} chunks "
        f"({probs_s * 1e3:.2f} ms on the card for {len(padded) / 16000:.0f} s); "
        f"split_windows through the model VAD {split_s:.3f} s: windows at "
        f"{[s for s, _ in windows]} ms (energy VAD: {[s for s, _ in energy]}); "
        f"{int(act.sum())} of {len(act)} frames active, {int((~clear).sum())} frames "
        f"within {VAD_MARGIN} of 0.5 ({card})")
    return {"max_abs_err_init": raw_err, "max_abs_err": err, "probs_ms": probs_s * 1e3, "split_windows_s": split_s,
            "windows": [s for s, _ in windows], "active_frames": int(act.sum()),
            "frames": len(act), "card": card}


def phase_diarization(dev, wav: str, card: str) -> dict:
    """8.4 ECAPA-TDNN at full published width (random, seed 0): fp32 card
    (TF32 off) vs CPU within MODEL_TOL of the largest |value|, bf16 on the
    card at cosine >= ECAPA_COS to fp32; then run_task("speaker_diarization")
    on the wav after a warm-up: windows, windows/s, turns, wall, peak."""
    import torch

    from eioku_tpu_torch.ml import audio_io, diarize
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.models.speaker.model import EcapaConfig, ecapa_embed, init_ecapa

    windows = diarize.slice_windows(audio_io.load_wav(wav))[:ECAPA_WINDOWS]
    x = torch.from_numpy(np.stack([w for _, w in windows]))
    model = init_ecapa(EcapaConfig(), torch.Generator().manual_seed(0))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ecapa_embed(model, x)
        card_model = model.to(dev)
        got = ecapa_embed(card_model, x.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    err = float((got - want).abs().max())
    if not err <= MODEL_TOL * max(float(want.abs().max()), 1.0):
        raise AssertionError(f"ECAPA fp32 card vs CPU: {err}")
    card_model.cfg = EcapaConfig(compute_dtype="bfloat16")
    bf16 = ecapa_embed(card_model, x.to(dev)).cpu()
    cos = float((bf16 * want).sum(dim=1).min())
    if not cos >= ECAPA_COS:
        raise AssertionError(f"ECAPA bf16 cosine to fp32 {cos}")
    engine = InferenceEngine(device=dev)
    engine.run_task("speaker_diarization", wav, {})  # warm-up: the model, cuDNN
    with _counting(diarize, "embed_windows", len) as embedded:
        rows, wall, peak = _peak_run(engine.run_task, "speaker_diarization", wav, {})
    n = embedded[0]
    if not rows or not all(r["span_end_ms"] > r["span_start_ms"] for r in rows):
        raise AssertionError(f"diarization: {len(rows)} turns")
    log(f"ECAPA fp32 card vs CPU max abs err {err:.2e}; bf16 vs fp32 cosine min "
        f"{cos:.5f}; speaker_diarization (bf16): {n} windows in {wall:.3f} s "
        f"({n / wall:.1f} windows/s), {len(rows)} turns, "
        f"{len({r['payload']['label'] for r in rows})} speakers, peak {peak:.1f} MiB ({card})")
    return {"ecapa_max_abs_err": err, "ecapa_bf16_min_cos": cos, "windows": n,
            "wall_s": wall, "windows_per_s": n / wall, "turns": len(rows),
            "peak_mib": peak, "card": card}


def phase_audio(dev, wav: str, workdir: str, card: str) -> dict:
    """Phase 8: the audio slice (int8, the Whisper options, the model VAD,
    diarization) on the card."""
    return {"int8_linears": phase_int8_linears(dev, card),
            "int8_transcription": phase_int8_transcription(dev, wav, card),
            "int8_embed": phase_embed_int8(dev, workdir, card),
            "whisper_options": phase_whisper_options(dev, wav, workdir, card),
            "vad": phase_vad(dev, wav, workdir, card),
            "diarization": phase_diarization(dev, wav, card)}


# -- phase 9: the HTTP API as its own process, the worker beside it, the CLI -------------

API_REQUESTS = 50  # timed requests per search mode
API_CONCURRENT = 8  # semantic searches in flight while /health is timed
API_SEARCH_TOL = 2e-2  # a hit's score, API process against this process (both bf16)
UPLOAD_SECONDS, UPLOAD_CUT_EVERY_S = 20, 4  # the uploaded clip: 5 segments, 4 cuts
UPLOAD_COLORS = [(20, 160, 200), (240, 120, 20), (90, 90, 250), (10, 220, 120),
                 (250, 250, 250)]


class ApiClient:
    """The API process over a localhost socket (urllib; one connection per
    request, as a browser's fetch without keep-alive)."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def request(self, path: str, method: str = "GET", data: bytes | None = None,
                headers: dict | None = None, expect: int = 200):
        """(body, content type, ms); any other status than `expect` fails."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=data, method=method,
                                     headers=headers or {})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                body, status, ctype = r.read(), r.status, r.headers.get("content-type", "")
        except urllib.error.HTTPError as e:
            body, status, ctype = e.read(), e.code, e.headers.get("content-type", "")
        ms = (time.perf_counter() - t) * 1e3
        if status != expect:
            raise AssertionError(f"api: {method} {path} answered {status} (want {expect}): "
                                 f"{body[:300]!r}")
        return body, ctype, ms

    def json(self, path: str, **kw):
        body, ctype, ms = self.request(path, **kw)
        if not ctype.startswith("application/json"):
            raise AssertionError(f"api: {path} answered {ctype}")
        return json.loads(body), ms


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _service_env() -> dict:
    """The environment of the service processes (started with `python -m`
    from the checkout's root): no EIOKU_FORCE_CPU, so they run on the card."""
    env = dict(os.environ)
    env.pop("EIOKU_FORCE_CPU", None)
    return env


def _jsonable(x):
    return json.loads(json.dumps(x))


def _same_hits(got: list, want: list, label: str) -> float:
    """The same hits in the same order, scores within API_SEARCH_TOL;
    returns the largest score difference."""
    strip = lambda h: {k: v for k, v in h.items() if k not in ("score", "rerank_score")}  # noqa: E731
    if [strip(h) for h in got] != [strip(h) for h in want] or not want:
        raise AssertionError(f"api {label}: hits {got[:3]} differ from {want[:3]}")
    worst = max(abs(g["score"] - w["score"]) for g, w in zip(got, want))
    if worst > API_SEARCH_TOL:
        raise AssertionError(f"api {label}: scores differ by {worst}")
    return worst


def _percentiles(times: list[float]) -> dict:
    a = np.asarray(times)
    return {"p50_ms": float(np.percentile(a, 50)), "p95_ms": float(np.percentile(a, 95))}


def _api_routes(api: ApiClient, ctx, clip_id: str, wav_id: str, clip_path: str) -> dict:
    """9.2 the routes that read the database the worker wrote: each answer
    equals what this process reads from the same database."""
    from urllib.parse import quote

    import cv2

    from eioku_tpu_torch.api.controllers import _attribute_speakers
    from eioku_tpu_torch.services.people import cluster_people
    from eioku_tpu_torch.services.subtitles import to_srt, to_vtt

    checked = 0
    videos, _ = api.json("/api/v1/videos")
    if sorted(v["id"] for v in videos["videos"]) != sorted(v.id for v in ctx.videos.list()):
        raise AssertionError(f"api /videos: {videos}")
    for kind in ("object.detection", "face.detection", "ocr.text", "scene",
                 "place.classification"):
        got, _ = api.json(f"/api/v1/videos/{clip_id}/artifacts?type={kind}")
        want = [e.to_dict() for e in ctx.artifacts.get_by_asset(
            clip_id, artifact_type=kind, selection=ctx.policies.get_policy(clip_id, kind),
            limit=10000)]
        if got["artifacts"] != _jsonable(want) or not want:
            raise AssertionError(f"api artifacts {kind}: {got['total']} rows, want {len(want)}")
        checked += 1
    jumps = {}
    for kind, t in (("object", 0), ("face", 0), ("scene", 15000)):
        got, _ = api.json(f"/api/v1/videos/{clip_id}/jump?kind={kind}&from_ms={t}")
        want = ctx.jump.jump(clip_id, kind, from_ms=t)
        if got != {"found": want is not None, "jump_to": _jsonable(want)} or want is None:
            raise AssertionError(f"api jump {kind}: {got} (want {want})")
        jumps[kind] = want["start_ms"]
        checked += 1
    words = {}
    for vid, table in ((clip_id, "ocr_fts"), (wav_id, "transcript_fts")):
        texts = [r[0] for r in ctx.db.query(
            f"SELECT f.text FROM {table} f JOIN {table}_meta m ON m.rowid = f.rowid "
            "WHERE m.asset_id = ?", (vid,))]
        word = sorted({w for t in texts for w in re.findall(r"[^\W_]+", t)},
                      key=lambda w: (-len(w), w))[0]
        got, _ = api.json(f"/api/v1/videos/{vid}/find?q={quote(word)}")
        want = ctx.find.find(vid, word)
        if got["matches"] != _jsonable(want) or not want:
            raise AssertionError(f"api find {word!r}: {got}")
        words[table] = word
        checked += 1
    segs = [e.to_dict() for e in ctx.artifacts.get_by_asset(
        wav_id, artifact_type="transcript.segment",
        selection=ctx.policies.get_policy(wav_id, "transcript.segment"), limit=100000)]
    speakers = json.loads(json.dumps(segs))
    _attribute_speakers(ctx, wav_id, speakers)
    for query, want, ctype in (("format=vtt", to_vtt(segs), "text/vtt"),
                               ("format=srt", to_srt(segs), "application/x-subrip"),
                               ("format=vtt&with_speakers=1", to_vtt(speakers), "text/vtt")):
        body, got_type, _ = api.request(f"/api/v1/videos/{wav_id}/subtitles?{query}")
        if body.decode() != want or not got_type.startswith(ctype) or len(want) < 20:
            raise AssertionError(f"api subtitles {query}: {body[:200]!r}")
        checked += 1
    people, _ = api.json("/api/v1/people")
    if people["people"] != _jsonable(cluster_people(ctx)):
        raise AssertionError(f"api /people: {people['total']} persons")
    checked += 1
    thumbs = []
    for _ in range(2):  # cold (seek, decode, encode), then from the cache
        body, ctype, ms = api.request(f"/api/v1/videos/{clip_id}/thumbnail")
        if ctype != "image/jpeg" or body[:2] != b"\xff\xd8":
            raise AssertionError(f"api thumbnail: {ctype}")
        thumbs.append((body, ms))
    if thumbs[0][0] != thumbs[1][0]:
        raise AssertionError("api thumbnail: the cached image differs")
    body, ctype, clip_ms = api.request(
        f"/api/v1/videos/{clip_id}/clip?start_ms=10000&end_ms=15000")
    out = os.path.join(os.path.dirname(os.path.dirname(clip_path)), "exported_clip.mp4")
    with open(out, "wb") as f:
        f.write(body)
    cap = cv2.VideoCapture(out)
    clip_frames = 0
    while cap.read()[0]:
        clip_frames += 1
    cap.release()
    if ctype != "video/mp4" or not 5 * CLIP_FPS - 5 <= clip_frames <= 5 * CLIP_FPS + 5:
        raise AssertionError(f"api clip: {ctype}, {clip_frames} frames for 5 s")
    body, ctype, _ = api.request(f"/api/v1/videos/{clip_id}/stream",
                                 headers={"Range": "bytes=1000-5095"}, expect=206)
    with open(clip_path, "rb") as f:
        f.seek(1000)
        if body != f.read(4096):
            raise AssertionError("api stream: the range's bytes differ from the file's")
    tasks, _ = api.json("/api/v1/tasks")
    stats, _ = api.json("/api/v1/stats")
    if tasks["total"] != ctx.tasks.count() or stats["videos"]["total"] != ctx.videos.count() \
            or stats["semantic_index"]["chunks"] != ctx.db.scalar(
                "SELECT COUNT(*) FROM embedding_chunks"):
        raise AssertionError(f"api tasks/stats: {tasks['total']}, {stats}")
    body, ctype, _ = api.request("/api/v1/metrics?format=prometheus")
    if not ctype.startswith("text/plain") or b"eioku_" not in body:
        raise AssertionError(f"api metrics: {body[:200]!r}")
    spec, _ = api.json("/openapi.json")
    body, ctype, _ = api.request("/")
    if "/api/v1/search" not in spec["paths"] or not ctype.startswith("text/html"):
        raise AssertionError("api: /openapi.json or the SPA")
    checked += 10
    log(f"api routes: {checked} checks against the database; jumps {jumps}, find "
        f"{words}, {people['total']} persons; thumbnail cold {thumbs[0][1]:.1f} ms, "
        f"cached {thumbs[1][1]:.1f} ms; clip 5 s ({clip_frames} frames, cv2 re-encode) "
        f"{clip_ms:.1f} ms")
    return {"checks": checked, "thumbnail_cold_ms": thumbs[0][1],
            "thumbnail_cached_ms": thumbs[1][1], "clip_5s_ms": clip_ms,
            "clip_frames": clip_frames, "persons": people["total"], "find_words": words}


def _api_search(api: ApiClient, ctx, clip_id: str, q_sem: str, word: str) -> dict:
    """9.3 search on the card: the first semantic call (MiniLM loads in the
    API process) timed apart, then API_REQUESTS calls per mode; the hits
    equal this process's indexes' on the same files."""
    from urllib.parse import quote

    sem_path = f"/api/v1/search?q={quote(q_sem)}&top_k=10"
    cold, cold_ms = api.json(sem_path)
    local = ctx.extra["semantic_index"].search(q_sem, top_k=10)
    sem_err = _same_hits(cold["results"], _jsonable(local), "semantic")
    q_vis = "a red frame"
    modes = {
        "semantic": sem_path,
        "keyword": f"/api/v1/search?q={quote(word)}&mode=keyword&top_k=10",
        "hybrid": f"/api/v1/search?q={quote(q_sem)}&mode=hybrid&top_k=10",
        "visual": f"/api/v1/search?q={quote(q_vis)}&mode=visual&top_k=10",
        "semantic_rerank": f"{sem_path}&rerank=1",
        "similar": f"/api/v1/videos/{clip_id}/similar?at_ms=15000&top_k=10",
    }
    out = {"cold_semantic_ms": cold_ms, "semantic_max_score_diff": sem_err}
    for mode, path in modes.items():
        first, first_ms = api.json(path)  # loads the mode's model where it has one
        times = [api.json(path)[1] for _ in range(API_REQUESTS)]
        out[mode] = {"first_ms": first_ms, **_percentiles(times),
                     "hits": len(first["results"])}
        if not first["results"]:
            raise AssertionError(f"api search {mode}: no hit")
        if mode == "visual":
            local = ctx.extra["visual_index"].search(q_vis, 10, None)
            out["visual_max_score_diff"] = _same_hits(first["results"], _jsonable(local),
                                                      "visual")
        if mode in ("semantic", "visual"):  # the index call alone, in this process
            index = ctx.extra[f"{mode}_index"]
            query = q_sem if mode == "semantic" else q_vis
            local_ms = []
            for _ in range(API_REQUESTS):
                t = time.perf_counter()
                index.search(query, 10)
                local_ms.append((time.perf_counter() - t) * 1e3)
            out[mode]["index_call_p50_ms"] = float(np.median(local_ms))
        if mode == "semantic_rerank" and first.get("reranked") is not True:
            raise AssertionError(f"api rerank: reranked is {first.get('reranked')}")
        log(f"api search {mode}: first {first_ms:.2f} ms, p50 {out[mode]['p50_ms']:.2f} "
            f"ms, p95 {out[mode]['p95_ms']:.2f} ms over {API_REQUESTS} requests, "
            f"{len(first['results'])} hits; the index call alone in this process "
            f"{out[mode].get('index_call_p50_ms', float('nan')):.2f} ms p50")
    return out


def _api_under_load(api: ApiClient, q_sem: str) -> dict:
    """9.4 /health alone, and issued among API_CONCURRENT semantic searches
    (which run on the server's event loop thread)."""
    import threading
    from urllib.parse import quote

    idle = [api.request("/health")[2] for _ in range(20)]
    done, errors = [], []

    def search():
        try:
            done.append(api.json(f"/api/v1/search?q={quote(q_sem)}&top_k=10")[1])
        except Exception as e:  # read after the join
            errors.append(e)
    threads = [threading.Thread(target=search) for _ in range(API_CONCURRENT)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    time.sleep(0.005)
    health_ms = api.request("/health")[2]
    for th in threads:
        th.join(300)
    wall = (time.perf_counter() - t) * 1e3
    if errors or len(done) != API_CONCURRENT:
        raise AssertionError(f"api under load: {errors}")
    out = {"health_idle_p50_ms": float(np.median(idle)),
           "health_among_searches_ms": health_ms, "searches": API_CONCURRENT,
           "searches_wall_ms": wall, "search_ms_max": max(done)}
    log(f"api under load: /health {health_ms:.1f} ms among {API_CONCURRENT} concurrent "
        f"semantic searches (idle p50 {out['health_idle_p50_ms']:.2f} ms); the searches "
        f"took {wall:.1f} ms together, the slowest {max(done):.1f} ms")
    return out


def _api_upload(api: ApiClient, ctx, dev, workdir: str, cache: str) -> dict:
    """9.5 PUT an upload, drain the queue with the port's worker in this
    process (the API process keeps running on the same card), then poll the
    API until the new video answers visual search and jump."""
    import asyncio
    from urllib.parse import quote

    import torch

    from eioku_tpu_torch.domain.models import TaskStatus
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.queue.worker import WorkerSettings
    from eioku_tpu_torch.workers.main import build_worker

    second = os.path.join(workdir, "second.mp4")
    cuts = write_clip(second, UPLOAD_SECONDS, UPLOAD_CUT_EVERY_S, UPLOAD_COLORS, seed=1)
    with open(second, "rb") as f:
        data = f.read()
    engine = InferenceEngine(model_cache_dir=cache, device=dev)
    engine_s, worker_s = {}, {}
    run_task = engine.run_task

    def timed_run_task(task_type, video_path, cfg):
        t = time.perf_counter()
        try:
            return run_task(task_type, video_path, cfg)
        finally:
            torch.cuda.synchronize()
            engine_s[task_type] = time.perf_counter() - t
    engine.run_task = timed_run_task
    worker = build_worker(app_ctx=ctx, engine=engine,
                          settings=WorkerSettings(max_jobs=1, poll_delay_s=0.01))
    process = worker.functions["process_ml_task"]

    async def timed_process(job_ctx, task_id, task_type, *args, **kwargs):
        t = time.perf_counter()
        try:
            return await process(job_ctx, task_id, task_type, *args, **kwargs)
        finally:
            worker_s[task_type] = time.perf_counter() - t
    worker.register("process_ml_task", timed_process)

    t0 = time.perf_counter()
    body, _, upload_ms = api.request("/api/v1/videos/upload?filename=second.mp4",
                                     method="PUT", data=data, expect=201,
                                     headers={"Content-Type": "application/octet-stream"})
    uploaded = json.loads(body)
    vid = uploaded["video"]["id"]
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    asyncio.run(worker.drain())
    drain_s = time.perf_counter() - t
    launches = _cuda.launch_counts()
    tasks = {t.task_type: t for t in ctx.tasks.find(video_id=vid, limit=20)}
    if "visual_indexing" not in tasks or any(
            t.status is not TaskStatus.COMPLETED for t in tasks.values()):
        raise AssertionError("api upload: tasks " + str(
            [(t.task_type, t.status.value, t.error) for t in tasks.values()]))
    if launches["scene_diff"] != 1 or launches["nms"] != 2:
        raise AssertionError(f"api upload: expected K1 x1 and K2 x2 in the drain, "
                             f"got {launches}")
    keyframes = ctx.db.scalar("SELECT COUNT(*) FROM frame_embeddings WHERE asset_id = ?",
                              (vid,))
    polls, first_search_ms = 0, None
    while True:
        hits, ms = api.json(f"/api/v1/search?q={quote('a red frame')}&mode=visual"
                            f"&top_k=50&video_id={vid}")
        first_search_ms = ms if first_search_ms is None else first_search_ms
        jump, _ = api.json(f"/api/v1/videos/{vid}/jump?kind=scene&from_ms=1")
        polls += 1
        if hits["results"] and jump["found"]:
            break
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"api upload: {vid} not searchable: {hits}, {jump}")
        time.sleep(0.05)
    total_s = time.perf_counter() - t0
    if len(hits["results"]) != keyframes or keyframes != cuts + 1 or \
            abs(jump["jump_to"]["start_ms"] - UPLOAD_CUT_EVERY_S * 1000) > 300:
        raise AssertionError(f"api upload: {len(hits['results'])} visual hits for "
                             f"{keyframes} keyframes ({cuts} cuts); next scene {jump}")
    engine_tasks = [t for t in engine_s if t in worker_s]
    out = {"video_id": vid, "bytes": len(data), "tasks": sorted(tasks),
           "upload_ms": upload_ms, "drain_s": drain_s,
           "engine_s": {t: engine_s[t] for t in engine_tasks},
           "host_stack_s": {t: worker_s[t] - engine_s[t] for t in engine_tasks},
           "followups_s": {t: worker_s[t] for t in worker_s if t not in engine_s},
           "first_search_after_append_ms": first_search_ms, "polls": polls,
           "upload_to_visually_searchable_s": total_s, "keyframes": keyframes,
           "launches": launches}
    log(f"api upload {len(data)} bytes: PUT {upload_ms:.1f} ms, drain {drain_s:.3f} s "
        f"(engine {out['engine_s']}, host stack {out['host_stack_s']}, follow-ups "
        f"{out['followups_s']}), first visual search after the append "
        f"{first_search_ms:.1f} ms; upload to visually searchable {total_s:.3f} s; "
        f"launches {launches}")
    return out


def _api_cli(ctx, cfg_path: str, db_url: str, workdir: str, q_sem: str,
             api_hits: list, persons: int) -> dict:
    """9.6 the ops CLI as its own processes on the card: search agrees with
    the API, stats and people with the database, and an export-dump
    imports into a fresh database with the same row counts."""
    cli = [sys.executable, "-m", "eioku_tpu_torch.cli", "--db", db_url, "--config", cfg_path]
    dump = os.path.join(workdir, "library.jsonl.gz")
    runs = {"search": ["search", q_sem, "--top-k", "10"], "stats": ["stats"],
            "people": ["people"], "export_dump": ["export-dump", "--out", dump]}
    env, repo = _service_env(), os.path.dirname(os.path.abspath(__file__))
    procs, out = {}, {}
    t = time.perf_counter()
    try:
        for name, args in runs.items():  # four processes at once
            procs[name] = subprocess.Popen(cli + args, cwd=repo, env=env, text=True,
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"cli {name}: rc {p.returncode}: {stderr[-2000:]}")
            out[name] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    parallel_s = time.perf_counter() - t
    lines = out["search"].splitlines()
    if len(lines) != len(api_hits) or not lines:
        raise AssertionError(f"cli search: {len(lines)} lines, the API {len(api_hits)} hits")
    for line, hit in zip(lines, api_hits):
        score, rest = line.split("  ", 1)
        want = (f"{hit['video_id'][:8]}  [{hit['jump_to']['start_ms']}ms]  "
                f"{hit['text'][:100]}")
        if rest != want or abs(float(score) - hit["score"]) > API_SEARCH_TOL + 1e-3:
            raise AssertionError(f"cli search: {line!r} against the API's {hit}")
    stats = json.loads(out["stats"])
    if stats["videos"]["total"] != ctx.videos.count():
        raise AssertionError(f"cli stats: {stats}")
    cli_persons = sum(1 for ln in out["people"].splitlines() if ln.startswith("person_"))
    if cli_persons != persons:
        raise AssertionError(f"cli people: {cli_persons} persons, the API {persons}")
    exported = json.loads(out["export_dump"])
    fresh = os.path.join(workdir, "restored.db")
    t = time.perf_counter()
    r = subprocess.run(cli[:4] + [f"sqlite:///{fresh}"] + cli[5:] +
                       ["import-dump", "--source", dump, "--no-reindex"],
                       cwd=repo, env=env, text=True, capture_output=True, timeout=300)
    import_s = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"cli import-dump: rc {r.returncode}: {r.stderr[-2000:]}")
    imported = json.loads(r.stdout)
    keys = ("videos", "tasks", "runs", "artifacts", "selections", "paths")
    if any(imported[k] != exported[k] for k in keys) or not exported["artifacts"]:
        raise AssertionError(f"cli dump: exported {exported}, imported {imported}")
    log(f"cli: search agrees with the API ({len(lines)} hits), stats, people ({persons}) "
        f"and export-dump as 4 processes in {parallel_s:.2f} s; import-dump into a fresh "
        f"database {import_s:.2f} s: {imported}")
    return {"search_hits": len(lines), "four_commands_s": parallel_s,
            "import_dump_s": import_s,
            "rows": {k: exported[k] for k in keys}}


def _device_memory() -> dict:
    """The card's used MiB and its compute processes (pid -> MiB), from
    nvidia-smi. In a container the pids may be the host's, not ours."""
    def query(args: list[str]) -> list[list[str]]:
        out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return [[x.strip() for x in line.split(",")] for line in out.strip().splitlines()]
    import torch

    apps = {int(pid): int(mib) for pid, mib in query(
        ["--query-compute-apps=pid,used_memory"]) if pid.isdigit() and mib.isdigit()}
    return {"used_mib": int(query(["--query-gpu=memory.used"])[0][0]), "apps": apps,
            "reserved_mib": torch.cuda.memory_reserved() / 2**20}


def _check_device(device: dict, card: str) -> None:
    """/api/v1/device names this card: the CUDA backend, platform gpu, and
    the name torch and nvidia-smi give."""
    import torch

    name = torch.cuda.get_device_name(0)
    if device["backend"] != "cuda" or device["devices"][0]["platform"] != "gpu" \
            or device["devices"][0]["kind"] != name or not card.startswith(name):
        raise AssertionError(f"api /device: {device} on {card}")


def phase_api(dev, workdir: str, card: str) -> dict:
    """Phase 9: the API as its own process on phase 4e's database, the
    worker beside it in this process, the ops CLI."""
    from urllib.parse import quote

    from eioku_tpu_torch.api.app import build_context
    from eioku_tpu_torch.config.settings import load_config

    root = os.path.join(workdir, "worker")
    db_url = f"sqlite:///{root}/eioku.db"
    # a cache of its own: phase 4e's MiniLM, phase 5's seeded cross-encoder
    # and its vocab.txt (which the MiniLM tokenizer then reads too, hazard m)
    cache = os.path.join(workdir, "api_models")
    os.makedirs(os.path.join(cache, "minilm-l6"))
    os.link(os.path.join(workdir, "models", "minilm-l6", "pytorch_model.bin"),
            os.path.join(cache, "minilm-l6", "pytorch_model.bin"))
    write_cross_encoder_checkpoint(cache, list(SEM_WORDS))
    cfg_path = os.path.join(workdir, "api_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"paths": [os.path.join(root, "videos")], "database_url": db_url,
                   "model_cache_dir": cache, "auto_discover": True, "combined_visual": True,
                   "active_task_types": ["scene_detection", "object_detection",
                                         "face_detection", "place_classification", "ocr",
                                         "metadata_extraction"],
                   "task_settings": {k: v for k, v in VISUAL_CONFIG.items() if v}}, f)
    ctx = build_context(load_config(cfg_path))  # this process: CUDA
    clip_id = ctx.videos.get_by_path(os.path.join(root, "videos", "clip.mp4")).id
    (wav_id,) = {r[0] for r in ctx.db.query(
        "SELECT asset_id FROM artifacts WHERE artifact_type = 'transcript.segment'")}
    q_sem = ctx.db.scalar("SELECT text FROM embedding_chunks WHERE asset_id = ? "
                          "ORDER BY slot DESC LIMIT 1", (wav_id,))
    wordpiece_built = os.path.exists(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "eioku_tpu_torch", "_build",
        "libwordpiece.so"))
    mem_before = _device_memory()  # this process alone on the card
    port = _free_port()
    log_path = os.path.join(workdir, "api.log")
    logf = open(log_path, "w")
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "eioku_tpu_torch.api.main", "--config", cfg_path,
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=_service_env(),
        stdout=logf, stderr=subprocess.STDOUT)
    api = ApiClient(port)
    try:
        while True:  # the first 200 on /health
            if proc.poll() is not None:
                raise AssertionError(f"api: the server exited with {proc.returncode}")
            try:
                api.request("/health")
                break
            except (OSError, AssertionError):
                if time.perf_counter() - t > 180:
                    raise
                time.sleep(0.05)
        startup_s = time.perf_counter() - t
        device, _ = api.json("/api/v1/device")
        _check_device(device, card)
        log(f"api: process {proc.pid} answered /health {startup_s:.2f} s after its start; "
            f"/device {device['devices'][0]}")
        routes = _api_routes(api, ctx, clip_id, wav_id,
                             os.path.join(root, "videos", "clip.mp4"))
        search = _api_search(api, ctx, clip_id, q_sem, routes["find_words"]["transcript_fts"])
        load = _api_under_load(api, q_sem)
        # the API process's share: the card's growth since before its start,
        # less what this process's allocator took meanwhile (its local
        # searches); this process's: the card's use before the start, plus
        # that growth of its allocator
        mem_after = _device_memory()
        grown = mem_after["reserved_mib"] - mem_before["reserved_mib"]
        memory = {"api_process_mib": mem_after["used_mib"] - mem_before["used_mib"] - grown,
                  "this_process_mib": mem_before["used_mib"] + grown,
                  "card_used_mib": mem_after["used_mib"],
                  "this_process_reserved_mib": mem_after["reserved_mib"],
                  "compute_apps": mem_after["apps"]}
        log(f"api: device memory after search warm-up (nvidia-smi): the card "
            f"{mem_after['used_mib']} MiB, the API process ~{memory['api_process_mib']:.0f} "
            f"MiB, this process ~{memory['this_process_mib']:.0f} MiB (its allocator "
            f"{mem_after['reserved_mib']:.0f} MiB); compute apps {mem_after['apps']} "
            f"(pids {proc.pid} and {os.getpid()} here) ({card})")
        upload = _api_upload(api, ctx, dev, workdir, cache)
        sem_hits, _ = api.json(f"/api/v1/search?q={quote(q_sem)}&top_k=10")
        cli = _api_cli(ctx, cfg_path, db_url, workdir, q_sem, sem_hits["results"],
                       routes["persons"])
    except Exception:
        logf.flush()
        with open(log_path) as f:
            log("api process output (tail):\n" + f.read()[-4000:])
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        logf.close()
    with open(log_path) as f:
        log("api process log (tail):\n" + "".join(f.readlines()[-12:]))
    search["wordpiece_shim_built_before_cold_call"] = wordpiece_built
    return {"startup_s": startup_s, "device": device["devices"][0], "routes": routes,
            "search": search, "under_load": load, "memory": memory, "upload": upload,
            "cli": cli, "card": card}


# -- phase 10: detection's options (device letterbox, int8 convs, data parallel) -----


def _matched_rows(want: list, got: list, box_px: float = 2.0, conf_tol: float = 0.02) -> int:
    """Rows of `want` matched one to one in `got` by frame and label, box
    corners within box_px and confidence within conf_tol."""
    pool: dict = {}
    for r in got:
        p = r["payload"]
        pool.setdefault((p["frame_number"], p.get("label")), []).append(p)
    matched = 0
    for r in want:
        p = r["payload"]
        cands = pool.get((p["frame_number"], p.get("label")), [])
        for i, q in enumerate(cands):
            bp, bq = p["bounding_box"], q["bounding_box"]
            if abs(p["confidence"] - q["confidence"]) <= conf_tol and all(
                    abs(bp[k] - bq[k]) <= box_px for k in ("x", "y", "width", "height")):
                matched += 1
                del cands[i]
                break
    return matched


def _detect_rows(model, images, meta, scale, pads, valid: int) -> list:
    from eioku_tpu_torch.ml import detection
    from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
    from eioku_tpu_torch.models.yolo.postprocess import detect

    rows: list = []
    detection.emit_boxes(rows, detection.fetch(detect(model, images, conf_threshold=0.5)),
                         meta, scale, pads, valid, 1.0, (CLIP_W, CLIP_H), 33, COCO_CLASSES)
    return rows


def _task_run(engine, task: str, clip: str, cfg: dict, label: str) -> tuple[list, dict]:
    import torch

    from eioku_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    out = engine.run_task(task, clip, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _cuda.launch_counts()
    rows = {k: len(v) for k, v in out.items()} if isinstance(out, dict) else {task: len(out)}
    res = {"wall_s": wall, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "rows": rows, "launches": {k: launches[k] for k in VISUAL_KERNELS}}
    log(f"{label}: {wall:.3f} s wall, peak {res['peak_mib']:.1f} MiB, rows {rows}, "
        f"launches {res['launches']}")
    if launches["nms"] < 1:
        raise AssertionError(f"{label}: K2 never launched")
    for name, rs in (out.items() if isinstance(out, dict) else [(task, out)]):
        if name in ("object_detection", "face_detection"):
            _check_box_rows(rs, f"{label} {name}")
    return out, res


def _letterbox_checks(dev, frames: np.ndarray, valid: int, cache: str) -> dict:
    """10.1 the device letterbox: fp32 card (TF32 off) vs CPU within
    LETTERBOX_TOL, and within one uint8 level of the host's cv2 letterbox
    (cv2 rounds to uint8, with 11-bit fixed-point weights); fp32 YOLOv8n
    rows from both on the same frames, compared and reported: the inputs
    differ by up to half a level by design, which moves the near-tie
    candidates of random weights (hazard b), so the rows are no gate."""
    import torch

    from eioku_tpu_torch.ml import detection
    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
    from eioku_tpu_torch.ops import resize

    size = detection.INPUT_SIZE
    x = torch.from_numpy(frames).to(dev)
    card = resize.letterbox_resize_normalize(x, size, size)
    cpu = resize.letterbox_resize_normalize(torch.from_numpy(frames[:LETTERBOX_CPU_FRAMES]),
                                            size, size)
    err = float((card[:LETTERBOX_CPU_FRAMES].cpu() - cpu).abs().max())
    host, scale, pads = detection.letterbox_batch(frames, valid)
    host_dev = torch.from_numpy(host).to(dev)
    vs_host = float((card[:valid] - host_dev[:valid].float() / 255.0).abs().max())
    ms = cuda_ms(lambda: resize.letterbox_resize_normalize(x, size, size), iters=10)
    host_s = time.perf_counter()
    detection.letterbox_batch(frames, valid)
    host_s = time.perf_counter() - host_s
    geometry = resize.letterbox_geometry(CLIP_H, CLIP_W, size)
    log(f"device letterbox [{len(frames)}, {CLIP_H}, {CLIP_W}] -> {size}: card vs CPU "
        f"max abs {err:.3e} (tolerance {LETTERBOX_TOL}), vs cv2 host {vs_host:.4f}; "
        f"{ms:.3f} ms on the card, {host_s * 1e3:.1f} ms cv2 on the host")
    if not err <= LETTERBOX_TOL or not vs_host <= 1 / 255 or geometry != (scale, *pads):
        raise AssertionError(f"device letterbox: {err} vs CPU, {vs_host} vs cv2, "
                             f"geometry {geometry} vs the host's {(scale, *pads)}")
    model = fold_batchnorm(YOLOv8(YoloConfig("yolov8n"),
                                  generator=torch.Generator().manual_seed(0)))
    model = model.to(dev).eval()  # fp32, TF32 off: rows at one precision
    meta = [(i * CLIP_FPS, i * 1000) for i in range(valid)]
    rows_host = _detect_rows(model, host_dev, meta, scale, pads, valid)
    rows_dev = _detect_rows(model, card, meta, scale, pads, valid)
    matched = _matched_rows(rows_host, rows_dev)
    share = matched / max(len(rows_host), len(rows_dev), 1)
    log(f"fp32 YOLOv8n rows on {valid} frames: host letterbox {len(rows_host)}, device "
        f"letterbox {len(rows_dev)}, {matched} matched ({share:.1%})")
    if not rows_host or not rows_dev:
        raise AssertionError(f"device letterbox rows: {len(rows_host)} / {len(rows_dev)}")
    return {"card_vs_cpu_max_abs": err, "vs_host_max_abs": vs_host, "ms": ms,
            "host_cv2_ms": host_s * 1e3, "fp32_rows": [len(rows_host), len(rows_dev)],
            "fp32_rows_matched": matched}


def _int8_conv_checks(dev, cache: str, host: np.ndarray) -> dict:
    """10.3 the int8 conv with the most weights in YOLOv8n: its int8
    activations and int32 sums card vs CPU on its main-path input (one
    detect batch), and its time beside the bf16 conv it replaces."""
    import torch

    from eioku_tpu_torch.ml import detection
    from eioku_tpu_torch.models.layers import QuantConv2d
    from eioku_tpu_torch.models.yolo.postprocess import detect
    from eioku_tpu_torch.ops import quant

    q_model = detection._load_model("yolov8n", 80, cache, dev, True)
    f_model = detection._load_model("yolov8n", 80, cache, dev, False)
    convs = [(n, m) for n, m in q_model.named_modules() if isinstance(m, QuantConv2d)]
    name, conv = max(convs, key=lambda nm: nm[1].w_q.numel())
    seen = {}
    hook = conv.register_forward_pre_hook(lambda mod, args: seen.setdefault("x", args[0]))
    detect(q_model, torch.from_numpy(host).to(dev), conf_threshold=0.5)
    hook.remove()
    x = seen["x"]
    xq, sx = quant.quant_act(x, dims=(1, 2, 3))
    xq_cpu, sx_cpu = quant.quant_act(x.cpu(), dims=(1, 2, 3))
    acc = quant.conv_int32(xq, conv.w_q, conv.stride, conv.dilation)
    acc_cpu = quant.conv_int32(xq_cpu, conv.w_q.cpu(), conv.stride, conv.dilation)
    torch.cuda.synchronize()
    same = (torch.equal(xq.cpu(), xq_cpu) and torch.equal(sx.cpu(), sx_cpu)
            and torch.equal(acc.cpu(), acc_cpu))
    fconv = f_model.get_submodule(name)
    q_ms = cuda_ms(conv, args=((x,),), iters=20)
    f_ms = cuda_ms(fconv, args=((x,),), iters=20)
    bytes_q = sum(b.numel() * b.element_size() for b in q_model.buffers())
    bytes_f = sum(t.numel() * t.element_size()
                  for t in (*f_model.parameters(), *f_model.buffers()))
    log(f"int8 conv {name} {list(conv.w_q.shape)} on {list(x.shape)} {x.dtype}: int8 "
        f"activations, scales and int32 sums card == CPU: {same}; {q_ms:.4f} ms int8, "
        f"{f_ms:.4f} ms bf16; weights {bytes_q / 2**20:.2f} MiB int8 model, "
        f"{bytes_f / 2**20:.2f} MiB bf16")
    if not same:
        raise AssertionError(f"int8 conv {name}: card and CPU differ")
    return {"layer": name, "weight_shape": list(conv.w_q.shape), "input": list(x.shape),
            "int8_ms": q_ms, "bf16_ms": f_ms, "model_mib_int8": bytes_q / 2**20,
            "model_mib_bf16": bytes_f / 2**20}


def _data_parallel_checks(dev, engine, clip: str, host: np.ndarray, plain_rows: list) -> dict:
    """10.4 data_parallel true on the one card (one replica) against the
    plain task; a DataParallelDetector over [cuda:0, cuda:0] (the split, K2
    per share, the gather) against the plain detect run on each share, bit
    for bit (fp32, TF32 off), and its rows against the plain detect of the
    whole batch at once (reported: cuDNN takes other kernels for 32 frames
    than for 64, which reorders the near-tie candidates of random weights,
    hazard b)."""
    import torch

    from eioku_tpu_torch.ml import detection
    from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
    from eioku_tpu_torch.models.yolo.postprocess import detect
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.parallel.inference import DataParallelDetector

    rows, res = _task_run(engine, "object_detection", clip,
                          {"batch_size": 64, "data_parallel": True},
                          "object_detection data_parallel=true")
    if rows != plain_rows:
        raise AssertionError("data_parallel=true rows differ from the plain task's")
    model = fold_batchnorm(YOLOv8(YoloConfig("yolov8n"),
                                  generator=torch.Generator().manual_seed(0)))
    model = model.to(dev).eval()
    frames = torch.from_numpy(host).to(dev)
    half = len(frames) // 2
    shares = [detect(model, frames[:half], conf_threshold=0.5),
              detect(model, frames[half:], conf_threshold=0.5)]
    want = {k: torch.cat([o[k] for o in shares]) for k in shares[0]}
    whole = detect(model, frames, conf_threshold=0.5)
    dp = DataParallelDetector(model, [dev, dev])
    _cuda.reset_launch_counts()
    got = dp(frames, conf_threshold=0.5)
    torch.cuda.synchronize()
    k2 = _cuda.launch_counts()["nms"]
    same = all(torch.equal(got[k], want[k]) for k in want)
    meta = [(i, 0) for i in range(len(frames))]

    def rows_of(out):
        r: list = []
        detection.emit_boxes(r, detection.fetch(out), meta, 1.0, (0, 0), len(frames),
                             1.0, (detection.INPUT_SIZE,) * 2, 33, COCO_CLASSES)
        return r

    rows_dp, rows_whole = rows_of(got), rows_of(whole)
    share = _matched_rows(rows_whole, rows_dp) / max(len(rows_whole), len(rows_dp), 1)
    dp_ms = cuda_ms(lambda: dp(frames, conf_threshold=0.5), iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: detect(model, frames, conf_threshold=0.5), iters=5, warmup=1)
    log(f"DataParallelDetector over [{dev}, {dev}]: {k2} K2 launches, equal to the plain "
        f"detect on each share: {same}; against the whole batch at once {share:.1%} of "
        f"{len(rows_whole)} rows matched; {dp_ms:.3f} ms against {plain_ms:.3f} ms")
    if k2 != 2 or not same:
        raise AssertionError(f"DataParallelDetector: K2 {k2}, equal per share {same}")
    return {"task_one_card": res, "two_replicas": {
        "k2_launches": k2, "rows_matched_whole_batch": share, "ms": dp_ms,
        "plain_ms": plain_ms}}


def phase_detection_options(dev, workdir: str, card: str) -> dict:
    """Phase 10: detection's options on the 60 s clip."""
    import torch

    from eioku_tpu_torch.ml import video_io
    from eioku_tpu_torch.ml.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clip = os.path.join(workdir, "clip.mp4")
    cache = os.path.join(workdir, "models")
    batch = next(iter(video_io.iter_frame_batches(clip, batch_size=64,
                                                  frame_interval_s=1.0)))
    out = {"letterbox": _letterbox_checks(dev, batch.frames, batch.valid, cache)}
    from eioku_tpu_torch.ml import detection

    host, _, _ = detection.letterbox_batch(batch.frames, batch.valid)
    engine = InferenceEngine(model_cache_dir=cache, device=dev)
    tasks = {}
    plain, tasks["object_detection"] = _task_run(engine, "object_detection", clip,
                                                 {"batch_size": 64}, "object_detection")
    rows, tasks["object_detection_device_letterbox"] = _task_run(
        engine, "object_detection", clip, {"batch_size": 64, "preprocess": "device"},
        "object_detection preprocess=device")
    share = _matched_rows(plain, rows) / max(len(plain), len(rows), 1)
    tasks["object_detection_device_letterbox"]["bf16_rows_matched_share"] = share
    log(f"bf16 task rows, device letterbox against host: {share:.1%} matched (bf16 "
        f"near-ties reorder, hazard b: the fp32 comparison above is the check)")
    for task, extra in (("object_detection", {"batch_size": 64}),
                        ("face_detection", {**VISUAL_CONFIG["face_detection"],
                                            "batch_size": 64})):
        if task == "face_detection":
            _task_run(engine, task, clip, extra, f"{task} bf16 warm-up")
            _, tasks[task] = _task_run(engine, task, clip, extra, f"{task} bf16")
        _task_run(engine, task, clip, {**extra, "int8": True}, f"{task} int8 warm-up")
        _, tasks[f"{task}_int8"] = _task_run(engine, task, clip, {**extra, "int8": True},
                                             f"{task} int8")
    int8_pass = {**VISUAL_CONFIG,
                 "object_detection": {**VISUAL_CONFIG["object_detection"], "int8": True},
                 "face_detection": {**VISUAL_CONFIG["face_detection"], "int8": True}}
    res_pass, tasks["visual_analysis_int8"] = _task_run(engine, "visual_analysis", clip,
                                                        int8_pass, "visual_analysis int8")
    _check_face_rows(res_pass["face_detection"], "visual int8")
    if tasks["visual_analysis_int8"]["launches"]["scene_diff"] < 1:
        raise AssertionError("visual_analysis int8: K1 never launched")
    out["int8_conv"] = _int8_conv_checks(dev, cache, host)
    out["data_parallel"] = _data_parallel_checks(dev, engine, clip, host, plain)
    out["tasks"] = tasks
    out["card"] = card
    return out


# -- phase 11: the embedder's fine-tune through the CLI, on phase 5's corpus ------------


def phase_finetune(dev, workdir: str, card: str) -> dict:
    """Phase 11: `python -m eioku_tpu_torch.cli finetune` as its own process on
    phase 5's database of indexed chunks and its seeded MiniLM; the first
    step's loss against the same batch on the CPU (fp32, TF32 off), the
    loss falling, the saved native.npz loaded by load_minilm; s per step in
    this process (the same step, timed apart)."""
    import random

    import torch

    from eioku_tpu_torch.models.embed.minilm import load_minilm
    from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer
    from eioku_tpu_torch.parallel.finetune import crop_pair
    from eioku_tpu_torch.parallel.train import adamw, info_nce_loss, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.join(workdir, "semantic")
    cache = os.path.join(root, "models")
    out_cache = os.path.join(workdir, "finetuned")
    save_to = os.path.join(out_cache, "minilm-l6", "native.npz")
    cfg_path = os.path.join(workdir, "finetune.json")
    with open(cfg_path, "w") as f:
        json.dump({"paths": [], "model_cache_dir": cache, "semantic_search": False,
                   "visual_search": False}, f)
    cmd = [sys.executable, "-m", "eioku_tpu_torch.cli", "--db", f"sqlite:///{root}/s.db",
           "--config", cfg_path, "finetune", "--steps", str(FINETUNE_STEPS),
           "--batch-size", str(FINETUNE_BATCH), "--save-to", save_to]
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=_service_env(), text=True, capture_output=True, timeout=600)
    wall = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"cli finetune: rc {r.returncode}: {r.stderr[-3000:]}")
    stats = json.loads(r.stdout)
    # the first batch, as the command drew it, through the same model on the CPU
    import sqlite3

    con = sqlite3.connect(os.path.join(root, "s.db"))
    texts = [t for (t,) in con.execute("SELECT text FROM embedding_chunks")
             if len(t.split()) >= 4]
    con.close()
    rng = random.Random(0)
    pairs = [crop_pair(rng.choice(texts), rng) for _ in range(FINETUNE_BATCH)]
    tok = WordPieceTokenizer.from_cache_dir(cache, max_len=128)
    batch = [torch.from_numpy(x) for x in (*tok.encode_batch([a for a, _ in pairs]),
                                           *tok.encode_batch([p for _, p in pairs]))]
    cpu_model, _, _ = load_minilm(cache)
    with torch.no_grad():
        cpu_loss = float(info_nce_loss(cpu_model, *batch))
    rel = abs(stats["first_loss"] - cpu_loss) / abs(cpu_loss)
    tuned, _, pretrained = load_minilm(out_cache, device=dev)
    moved = float((tuned.embeddings.word_embeddings.weight.cpu()
                   - cpu_model.embeddings.word_embeddings.weight).abs().max())
    # s per step: the same step on the card in this process, after a warm-up
    model, _, _ = load_minilm(cache, device=dev)
    step, _ = make_train_step(model, adamw(model, 1e-5))
    on_card = [b.to(dev) for b in batch]
    step(*on_card)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        step(*on_card)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t) / 5
    log(f"cli finetune: {stats['steps']} steps at batch {FINETUNE_BATCH} over "
        f"{stats['chunks']} chunks in {wall:.2f} s (the process); loss "
        f"{stats['first_loss']:.5f} -> {stats['last_loss']:.5f}; the first step's loss "
        f"on the CPU {cpu_loss:.5f} (relative {rel:.2e}); {per_step * 1e3:.1f} ms per "
        f"step on the card; the saved checkpoint loads (pretrained {pretrained}), "
        f"token embeddings moved up to {moved:.2e}")
    if not rel <= FINETUNE_LOSS_RTOL or not stats["last_loss"] < stats["first_loss"] \
            or not pretrained or not moved > 0 or stats["checkpoint"] != save_to:
        raise AssertionError(f"cli finetune: {stats}, CPU first loss {cpu_loss}, "
                             f"pretrained {pretrained}, moved {moved}")
    return {"stats": stats, "process_s": wall, "cpu_first_loss": cpu_loss,
            "first_loss_rel_err": rel, "s_per_step": per_step, "card": card}


# -- phase 12: the mesh and process group, TP and PP Whisper, ring attention, MoE ----------


_PROCESS_GROUP_CHILD = r"""
import json, time
import torch
from eioku_tpu_torch.parallel.mesh import Mesh, initialize_distributed

t = time.perf_counter()
assert initialize_distributed() is True
init_s = time.perf_counter() - t
backend = torch.distributed.get_backend()
x = torch.arange(4.0, device="cuda") + torch.distributed.get_rank()
torch.distributed.all_reduce(x)
comm = Mesh.over_process_group("cuda:0").lines("model")[0]
(s,) = comm.psum([x])
(g,) = comm.all_gather([x[None]])
torch.cuda.synchronize()
ok = torch.equal(x.cpu(), torch.arange(4.0)) and torch.equal(s, x) and torch.equal(g[0], x)
torch.distributed.destroy_process_group()
print(json.dumps({"backend": backend, "init_s": init_s, "ok": ok,
                  "world_size": 1, "device": torch.cuda.get_device_name(0)}))
"""


def _process_group() -> dict:
    """12.1 A process joins a world-size-1 group from the variables the
    worker reads, on the card: NCCL, an all_reduce and the port's
    collectives over it."""
    env = {**_service_env(), "EIOKU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "EIOKU_NUM_PROCESSES": "1", "EIOKU_PROCESS_ID": "0"}
    t = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", _PROCESS_GROUP_CHILD], env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t
    if done.returncode != 0:
        raise AssertionError(f"process group child exited {done.returncode}: "
                             f"{done.stderr[-2000:]}")
    out = json.loads(done.stdout.strip().splitlines()[-1])
    if out["backend"] != "nccl" or not out["ok"]:
        raise AssertionError(f"process group: {out}")
    log(f"12.1 process group: {out['backend']}, init {out['init_s']:.3f} s, "
        f"process {wall:.2f} s")
    return {**out, "process_s": wall}


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _k3_tp_heads(dev) -> dict:
    """K3 at the TP encoder's local heads, H = 10 and 5 (tp 2 and 4), in
    bf16 and f16, on [B, S, H, D] views of a [B, S, H D] projection as the
    TP encoder hands them over (no copy): against the plain version under
    3b's tolerance, then kernel / plain / bound / library times."""
    import torch
    import torch.nn.functional as F

    from eioku_tpu_torch.ops import flash_attention as fa

    b, _, s_len, d = K3_SHAPE
    out = {}
    for tp in TP_SIZES:
        h = K3_SHAPE[1] // tp
        for dtype in (torch.bfloat16, torch.float16):
            name = "bf16" if dtype == torch.bfloat16 else "f16"
            gen = torch.Generator(device=dev).manual_seed(h)
            sets = [tuple(torch.randn((b, s_len, h * d), generator=gen, device=dev)
                          .to(dtype).view(b, s_len, h, d).transpose(1, 2) for _ in range(3))
                    for _ in range(2)]
            q, k, v = sets[0]
            if any(fa._kernel_view(t) is not t for t in (q, k, v)):
                raise AssertionError(f"K3 copies the TP encoder's H = {h} views")
            got = fa.flash_attention(q, k, v)
            want = fa.flash_attention_plain(q, k, v)
            cancel = fa.flash_attention_plain(q.float(), k.float(), v.float().abs())
            torch.cuda.synchronize()
            err = k3_error(got, want, cancel)
            max_abs = float((got.float() - want.float()).abs().max())
            if not bool(torch.isfinite(got).all()) or not err <= 0.0:
                raise AssertionError(f"K3 at H = {h} {name}: excess {err}")
            nbytes = 4 * b * h * s_len * d * 2
            ops = 4 * b * h * s_len * s_len * d
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
            row = {"max_abs_err": max_abs, "excess_over_tolerance": err, "bound_ms": bound,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
                   else "operations",
                   "ms": cuda_ms(fa.flash_attention, iters=30, args=sets),
                   "plain_ms": cuda_ms(fa.flash_attention_plain, iters=5, warmup=1, args=sets),
                   "library_ms": cuda_ms(lambda q, k, v: F.scaled_dot_product_attention(
                       q, k, v, scale=d ** -0.5), iters=30, args=sets)}
            out[f"h{h}_{name}"] = row
            log(f"12.2 K3 [{b}, {h}, {s_len}, {d}] {name} (TP views): max abs err "
                f"{max_abs:.3e}, excess {err:.3e}; kernel {row['ms']:.5f} ms, plain "
                f"{row['plain_ms']:.5f} ms, SDPA {row['library_ms']:.5f} ms, bound "
                f"{bound:.5f} ms ({bound / row['ms']:.1%})")
    return out


def _tp_pp_encoders(dev, wav: str) -> dict:
    """12.2 and 12.4: the TP encoder over [cuda:0] * tp and the PP encoder
    over [cuda:0, cuda:0] against whisper_encode, bf16 and fp32 (TF32
    off)."""
    import copy
    import dataclasses

    import torch

    from eioku_tpu_torch.ml import transcribe

    # phase 4b's large-v3 (bf16, seed 0) and an fp32 copy of its weights
    model, cfg, _ = transcribe._load_model(
        WHISPER_CONFIG["model"], None, "bfloat16", WHISPER_CONFIG["random_full_size"], dev)
    m32 = copy.deepcopy(model).float()
    m32.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    torch.backends.cudnn.allow_tf32 = False  # the conv stem at fp32 too
    try:
        return _tp_pp_encoders_vs_one_device(dev, wav, model, m32)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        del m32
        torch.cuda.empty_cache()


def _tp_pp_encoders_vs_one_device(dev, wav: str, model, m32) -> dict:
    import torch

    from eioku_tpu_torch.ml import audio_io
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import (
        shard_whisper,
        whisper_encode,
        whisper_encode_pp,
        whisper_encode_tp,
    )
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.parallel.mesh import Mesh

    n_layers = model.cfg.n_enc_layers
    windows = audio_io.split_windows(audio_io.load_wav(wav))
    mel = log_mel_spectrogram(torch.from_numpy(np.stack([w for _, w in windows])).to(dev),
                              n_mels=model.cfg.n_mels)
    ref = whisper_encode(model, mel)
    ref32 = whisper_encode(m32, mel)
    bf16_err = _rel_err(ref, ref32)
    tol = TP_BF16_FACTOR * bf16_err
    log(f"12.2 bf16 one-device encoder vs fp32 on the same weights: {bf16_err:.3e} "
        f"of max |value|; TP/PP bf16 tolerance {tol:.3e}")
    out = {"windows": len(windows), "bf16_vs_fp32": bf16_err, "bf16_tol": tol}

    def check(label: str, fn, launches_want: int) -> dict:
        row = {}
        for name, m, want, limit in (("bf16", model, ref, tol), ("fp32", m32, ref32, TP_FP32_TOL)):
            fn(m)  # warm-up (shards, cuBLAS)
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t = time.perf_counter()
            got = fn(m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = _cuda.launch_counts()["flash_attention"]
            err = _rel_err(got, want)
            log(f"{label} {name}: {err:.3e} of max |value| from one device (limit "
                f"{limit:.1e}), {wall:.3f} s, K3 {launches} launches")
            if not bool(torch.isfinite(got).all()) or got.shape != want.shape \
                    or not err <= limit or launches != launches_want:
                raise AssertionError(f"{label} {name}: err {err}, launches {launches}")
            row[name] = {"rel_err": err, "wall_s": wall, "k3_launches": launches}
        return row

    for tp in TP_SIZES:
        mesh = Mesh([[dev] * tp])
        shards = {id(m): shard_whisper(m, mesh) for m in (model, m32)}
        out[f"tp{tp}"] = check(f"12.2 TP encoder tp {tp} (shards serial on one card)",
                               lambda m: whisper_encode_tp(shards[id(m)], mel),
                               n_layers * tp)
    t = time.perf_counter()
    whisper_encode(model, mel)
    torch.cuda.synchronize()
    out["one_device_wall_s"] = time.perf_counter() - t
    pp_mesh = Mesh([[dev, dev]])
    out["pp"] = check("12.4 PP encoder, 2 stages of 16 layers, 2 microbatches",
                      lambda m: whisper_encode_pp(m, mel, pp_mesh, n_micro=PP_MICRO),
                      n_layers * PP_MICRO)
    return out


def _tp_task_rows(dev, wav: str, workdir: str) -> dict:
    """12.3 run_task("transcription") with tensor_parallel 2 on phase 4d's
    seeded tiny checkpoint, `local_devices` replaced by [cuda:0, cuda:0],
    against the one-device task at fp32 (TF32 off): rows equal, the
    confidence within 1e-3 (the JAX test's rule)."""
    import logging

    import torch

    from eioku_tpu_torch.ml import transcribe
    from eioku_tpu_torch.ml.engine import InferenceEngine
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.parallel import mesh

    cache = os.path.join(workdir, "models")  # whisper-tiny.npz from phase 4d
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    transcribe.log.addHandler(handler)
    level = transcribe.log.level
    transcribe.log.setLevel(logging.INFO)
    local_devices = mesh.local_devices
    mesh.local_devices = lambda device=None: [dev, dev]
    torch.backends.cudnn.allow_tf32 = False
    engine = InferenceEngine(model_cache_dir=cache, device=dev)
    try:
        one = engine.run_task("transcription", wav, TINY_CONFIG)
        _cuda.reset_launch_counts()
        with _counting(transcribe, "whisper_encode_tp") as enc_calls:
            t = time.perf_counter()
            tp = engine.run_task("transcription", wav, {**TINY_CONFIG, "tensor_parallel": 2})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = _cuda.launch_counts()["flash_attention"]
    finally:
        mesh.local_devices = local_devices
        torch.backends.cudnn.allow_tf32 = True
        transcribe.log.removeHandler(handler)
        transcribe.log.setLevel(level)
        transcribe._tp_shards.cache_clear()
        transcribe._load_model.cache_clear()
    strip = lambda rs: [{**r, "payload": {k: v for k, v in r["payload"].items()  # noqa: E731
                                          if k != "confidence"}} for r in rs]
    conf = max((abs(a["payload"]["confidence"] - b["payload"]["confidence"])
                for a, b in zip(tp, one)), default=0.0)
    if "tensor-parallel transcription" not in records or not one \
            or strip(tp) != strip(one) or not conf < 1e-3 or not enc_calls \
            or launches != 4 * 2 * len(enc_calls):
        raise AssertionError(f"TP task: {len(tp)} rows vs {len(one)}, confidence "
                             f"{conf}, K3 {launches} for {len(enc_calls)} encoder calls, "
                             f"log {records[-3:]}")
    log(f"12.3 tiny transcription, tensor_parallel 2 over [cuda:0, cuda:0]: {len(tp)} "
        f"rows equal to one device's (confidence within {conf:.1e}), {wall:.3f} s, "
        f"K3 {launches} launches")
    return {"rows": len(tp), "rows_equal": True, "confidence_max_diff": conf,
            "wall_s": wall, "k3_launches": launches, "encoder_calls": len(enc_calls)}


def _device_ops(fn) -> int:
    """Device operations (kernels and copies) that fn launches, from a
    torch.profiler trace."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _tp_decode_large(dev, wav: str) -> dict:
    """12.3 large-v3 bf16, beam 5, TP_DECODE_LEN tokens with EOT suppressed
    (every row runs every step), on the one-device encoding of the 4 voiced
    windows: the TP decode over [cuda:0, cuda:0] against one device (the
    share of tokens that agree and the one-device top-2 margin where they
    first part), walls, and device operations per step."""
    import torch

    from eioku_tpu_torch.ml import audio_io, transcribe
    from eioku_tpu_torch.models.whisper import decoding
    from eioku_tpu_torch.models.whisper.mel import log_mel_spectrogram
    from eioku_tpu_torch.models.whisper.model import shard_whisper, whisper_encode
    from eioku_tpu_torch.models.whisper.tokenizer import WhisperTokens
    from eioku_tpu_torch.parallel.mesh import Mesh

    model, cfg, _ = transcribe._load_model(
        WHISPER_CONFIG["model"], None, "bfloat16", WHISPER_CONFIG["random_full_size"], dev)
    windows = audio_io.split_windows(audio_io.load_wav(wav))
    mel = log_mel_spectrogram(torch.from_numpy(np.stack([w for _, w in windows])).to(dev),
                              n_mels=cfg.n_mels)
    enc = whisper_encode(model, mel)
    tk = WhisperTokens(cfg.vocab_size)
    sot = tk.sot_sequence("en")
    init = torch.tensor([sot] * len(windows), device=dev)
    sup_a, sup_b = decoding.build_suppress_masks(tk, timestamps=True)
    sup_a[tk.eot] = True
    shards = shard_whisper(model, Mesh([[dev, dev]]))
    runs = {"one_device": lambda n: decoding.whisper_decode_windows(
                model, enc, init, sup_a, sup_b, max_len=n, beam_size=5),
            "tp2": lambda n: decoding.whisper_decode_windows_tp(
                shards, enc, init, sup_a, sup_b, max_len=n, beam_size=5)}
    out, rows = {}, {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows[name] = run(TP_DECODE_LEN)[0].cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        # a decode of max_len n runs n - 1 decoder steps: the difference of
        # two lengths leaves out the set-up (cross K/V, caches)
        per_step = (_device_ops(lambda: run(17)) - _device_ops(lambda: run(9))) / 8
        out[name] = {"wall_s": wall, "device_ops_per_step": per_step}
        log(f"12.3 {cfg.variant} bf16 decode {name}, beam 5, {len(windows)} windows x "
            f"{TP_DECODE_LEN - len(sot)} tokens: {wall:.3f} s, "
            f"{per_step:.0f} device operations a step")
    gen = slice(len(sot), None)
    agree = float((rows["tp2"][:, gen] == rows["one_device"][:, gen]).float().mean())
    margin = _first_divergence_margin(rows["one_device"], rows["tp2"], model, enc, sup_a,
                                      ("one device", "TP 2"))
    log(f"12.3 TP 2 tokens agree with one device's at {agree:.1%} of positions")
    return {**out, "token_agreement": agree, "first_divergence_margin": margin,
            "windows": len(windows)}


def _ring_and_moe(dev) -> dict:
    """12.5 ring attention over [cuda:0] * 4 against full attention, and
    the expert-parallel MoE over [cuda:0, cuda:0] against one device, both
    fp32 with TF32 off; their times beside the one-device versions'."""
    import torch

    from eioku_tpu_torch.ops import moe
    from eioku_tpu_torch.ops.flash_attention import flash_attention_plain
    from eioku_tpu_torch.ops.ring_attention import ring_attention
    from eioku_tpu_torch.parallel.mesh import Mesh

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=dev) * 0.3 for _ in range(3))
    ring_mesh = Mesh([[dev] * 4])
    got = ring_attention(q, k, v, ring_mesh, axis_name="model")
    want = flash_attention_plain(q, k, v)
    ring_err = float((got - want).abs().max())
    ring_ms = cuda_ms(lambda: ring_attention(q, k, v, ring_mesh, axis_name="model"),
                      iters=3, warmup=1)
    full_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), iters=3, warmup=1)
    log(f"12.5 ring attention {list(RING_SHAPE)} fp32 over [cuda:0] * 4: max abs err "
        f"{ring_err:.3e} from full attention; {ring_ms:.3f} ms, full {full_ms:.3f} ms")
    if not ring_err <= RING_TOL:
        raise AssertionError(f"ring attention: {ring_err}")
    d, ffn, n_experts, n = MOE_SHAPE
    params = moe.init_moe_params(d, ffn, n_experts, torch.Generator(device=dev).manual_seed(6),
                                 device=dev)
    x = torch.randn((n, d), generator=gen, device=dev)
    shards = moe.shard_moe_params(params, Mesh([[dev, dev]]))
    got, want = moe.moe_ffn(shards, x), moe.moe_ffn(params, x)
    moe_err = _rel_err(got, want)
    kept = float((got.abs().sum(dim=1) > 0).float().mean())
    moe_ms = cuda_ms(lambda: moe.moe_ffn(shards, x), iters=5, warmup=1)
    one_ms = cuda_ms(lambda: moe.moe_ffn(params, x), iters=5, warmup=1)
    log(f"12.5 MoE d {d}, ffn {ffn}, {n_experts} experts, {n} tokens over [cuda:0, "
        f"cuda:0]: {moe_err:.3e} of max |value| from one device, {kept:.1%} of tokens "
        f"kept; {moe_ms:.3f} ms, one device {one_ms:.3f} ms")
    if not moe_err <= MOE_RTOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"MoE: {moe_err}")
    return {"ring": {"shape": list(RING_SHAPE), "max_abs_err": ring_err, "ms": ring_ms,
                     "full_attention_ms": full_ms},
            "moe": {"shape": list(MOE_SHAPE), "rel_err": moe_err, "tokens_kept": kept,
                    "ms": moe_ms, "one_device_ms": one_ms}}


def phase_multi_device(dev, wav: str, workdir: str, card: str) -> dict:
    """Phase 12: the process group, TP and PP Whisper, ring attention and
    MoE; every shard of every mesh on the one card, one after the other, so
    no time here is a speed-up."""
    out = {"process_group": _process_group(), "k3_tp_heads": _k3_tp_heads(dev)}
    out["encoders"] = _tp_pp_encoders(dev, wav)
    out["tp_decode_large_v3"] = _tp_decode_large(dev, wav)
    out["tp_task"] = _tp_task_rows(dev, wav, workdir)
    out.update(_ring_and_moe(dev))
    out["card"] = card
    return out


# -- phase 13: training over several devices, on one card ---------------------------------


def _training_batches(root: str, cache: str, n: int) -> list:
    """n batches of FINETUNE_BATCH crop pairs of phase 5's indexed chunks,
    drawn as `cli finetune` draws them (its seed, its tokenizer at 128)."""
    import random
    import sqlite3

    import torch

    from eioku_tpu_torch.models.embed.tokenizer import WordPieceTokenizer
    from eioku_tpu_torch.parallel.finetune import crop_pair

    con = sqlite3.connect(os.path.join(root, "s.db"))
    texts = [t for (t,) in con.execute("SELECT text FROM embedding_chunks")
             if len(t.split()) >= 4]
    con.close()
    rng = random.Random(0)
    tok = WordPieceTokenizer.from_cache_dir(cache, max_len=128)
    out = []
    for _ in range(n):
        pairs = [crop_pair(rng.choice(texts), rng) for _ in range(FINETUNE_BATCH)]
        out.append([torch.from_numpy(x) for x in (*tok.encode_batch([a for a, _ in pairs]),
                                                  *tok.encode_batch([p for _, p in pairs]))])
    return out


def _train_gate(got: dict, got_grads: dict, want: dict, want_grads: dict,
                label: str) -> dict:
    """The first step's gradients within TRAIN_GRAD_RTOL of their leaf's
    largest |value| (a key bias's scale is its layer's query bias's), the
    parameters after the steps within TRAIN_RTOL / TRAIN_ATOL, except the
    elements with no gradient sign (within TRAIN_GRAD_RTOL of zero), held
    to TRAIN_STEP_BOUND."""
    worst_g = worst_p = 0.0
    signless = 0
    for name, w in want.items():
        ref = want_grads[name].float()
        scale = float(want_grads[name.replace("key.bias", "query.bias")].abs().max())
        dg = float((got_grads[name].float() - ref).abs().max())
        if dg > TRAIN_GRAD_RTOL * scale:
            raise AssertionError(f"{label}: the gradient of {name} departs {dg:.3e} "
                                 f"(scale {scale:.3e})")
        worst_g = max(worst_g, dg / scale)
        d = (got[name].float() - w.float()).abs()
        free = ref.abs() <= TRAIN_GRAD_RTOL * scale
        held = ~free
        if bool((d[free] > TRAIN_STEP_BOUND).any()) or \
                bool((d[held] > TRAIN_ATOL + TRAIN_RTOL * w.float().abs()[held]).any()):
            raise AssertionError(f"{label}: {name} departs {float(d.max()):.3e}")
        signless += int((free & (ref != 0)).sum())  # a zero gradient steps alike
        if bool(held.any()):
            worst_p = max(worst_p, float(d[held].max()))
    return {"grad_rel_err": worst_g, "param_max_abs_err": worst_p,
            "signless_elements": signless}


def _ms_per_step(step, batch) -> float:
    import torch

    step(*batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        step(*batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / TRAIN_TIMED * 1e3


def _dp_tp_steps(dev, cache: str, batches: list) -> tuple[dict, dict]:
    """13.1 the step over data 2, model 2 and a 2 x 2 mesh of cuda:0
    against the one-device step from the same weights."""
    import functools

    from eioku_tpu_torch.models.embed.minilm import load_minilm
    from eioku_tpu_torch.parallel.mesh import Mesh
    from eioku_tpu_torch.parallel.train import adamw, make_train_step

    model, _, _ = load_minilm(cache, device=dev)
    step, _ = make_train_step(model, adamw(model, TRAIN_LR))
    losses, grads = [], None
    for b in batches:
        losses.append(float(step(*b)))
        grads = grads or {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    want = {"losses": losses, "grads": grads,
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    out = {"one_device": {"losses": losses, "ms_per_step": _ms_per_step(step, batches[0])}}
    for name, grid in (("data2", [[dev], [dev]]), ("model2", [[dev, dev]]),
                       ("data2_model2", [[dev, dev], [dev, dev]])):
        fresh, _, _ = load_minilm(cache, device=dev)
        sharded, _ = make_train_step(fresh, functools.partial(adamw, lr=TRAIN_LR), Mesh(grid))
        got, got_grads = [], None
        for b in batches:
            got.append(float(sharded(*b)))
            got_grads = got_grads or sharded.gradients()
        rel = abs(got[0] - losses[0]) / abs(losses[0])
        gate = _train_gate(sharded.state_dict(), got_grads, want["params"], grads, name)
        ms = _ms_per_step(sharded, batches[0])
        log(f"13.1 {name} {Mesh(grid).shape}: first loss {got[0]:.6f} against one "
            f"device's {losses[0]:.6f} (relative {rel:.2e}); first gradients within "
            f"{gate['grad_rel_err']:.2e} of their scale; parameters after {TRAIN_STEPS} "
            f"steps within {gate['param_max_abs_err']:.3e} ({gate['signless_elements']} "
            f"signless elements to the step bound); {ms:.1f} ms per step, one device "
            f"{out['one_device']['ms_per_step']:.1f}")
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"13.1 {name}: first loss {got[0]} vs {losses[0]}")
        out[name] = {"losses": got, "first_loss_rel_err": rel, **gate, "ms_per_step": ms}
    return out, want


def _fsdp_and_checkpoints(dev, cache: str, batches: list, want: dict, workdir: str
                          ) -> dict:
    """13.2 FSDP over FSDP_ENTRIES x cuda:0 and 13.3 its sharded checkpoint:
    the same layout, data 2 and whole, and a resumed step."""
    import functools

    import torch

    from eioku_tpu_torch.models.checkpoint import restore_sharded, save_sharded
    from eioku_tpu_torch.models.embed.minilm import load_minilm
    from eioku_tpu_torch.parallel.fsdp import (
        gather_tree,
        gradients,
        make_fsdp_train_step,
        max_leaf_shard_fraction,
    )
    from eioku_tpu_torch.parallel.mesh import Mesh, tree_leaves
    from eioku_tpu_torch.parallel.train import adamw

    model, _, _ = load_minilm(cache, device=dev)
    opt = functools.partial(adamw, lr=TRAIN_LR)
    step, _, prepare = make_fsdp_train_step(model, Mesh([[dev]] * FSDP_ENTRIES), opt)
    params, state = prepare(model)
    frac = {"params": max_leaf_shard_fraction(params),
            "moments": max_leaf_shard_fraction([state["exp_avg"], state["exp_avg_sq"]])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, grads = [], None
    for b in batches:
        params, state, loss = step(params, state, *b)
        losses.append(float(loss))
        grads = grads or gradients(params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    rel = abs(losses[0] - want["losses"][0]) / abs(want["losses"][0])
    gate = _train_gate(gather_tree(params), grads, want["params"], want["grads"], "fsdp")
    frac_after = max_leaf_shard_fraction([params, state["exp_avg"], state["exp_avg_sq"]])
    log(f"13.2 FSDP over {FSDP_ENTRIES} x {dev}: largest share an entry holds "
        f"{frac['params']:.4f} (parameters), {frac['moments']:.4f} (moments), "
        f"{frac_after:.4f} after the steps; first loss relative {rel:.2e}; first "
        f"gradients within {gate['grad_rel_err']:.2e}; parameters within "
        f"{gate['param_max_abs_err']:.3e} ({gate['signless_elements']} signless); peak "
        f"{peak:.1f} MiB")
    if max(*frac.values(), frac_after) > 1 / FSDP_ENTRIES or not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"13.2 FSDP: shares {frac}, {frac_after}, loss {rel}")
    out = {"fsdp": {"entries": FSDP_ENTRIES, "shard_fraction": frac,
                    "shard_fraction_after": frac_after, "losses": losses,
                    "first_loss_rel_err": rel, **gate, "peak_mib": peak}}
    saved = {"params": params, "opt": state}
    path = os.path.join(workdir, "fsdp_ckpt")
    torch.cuda.synchronize()
    t = time.perf_counter()
    save_sharded(saved, path)
    save_s = time.perf_counter() - t
    written = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    t = time.perf_counter()
    back = restore_sharded(saved, path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t

    def equal(a, b) -> bool:
        la, lb = tree_leaves(gather_tree(a)), tree_leaves(gather_tree(b))
        return len(la) == len(lb) and all(torch.equal(x.to(dev), y.to(dev))
                                          for x, y in zip(la, lb))
    same = equal(back, saved)
    resharded = {}
    for name, n in (("data2", 2), ("whole", 1)):
        p2, o2 = make_fsdp_train_step(model, Mesh([[dev]] * n), opt)[2](model)
        resharded[name] = equal(restore_sharded({"params": p2, "opt": o2}, path), saved)
    _, _, loss_cont = step(params, state, *batches[0])
    _, _, loss_res = step(back["params"], back["opt"], *batches[0])
    resumed = float(loss_res) == float(loss_cont) and equal(back, saved)
    log(f"13.3 sharded checkpoint: {written / 2**20:.1f} MiB written in {save_s:.3f} s, "
        f"restored in {restore_s:.3f} s; same layout bit-equal {same}, into data 2 "
        f"{resharded['data2']}, into one entry {resharded['whole']}; a step after the "
        f"restore equals the uninterrupted step {resumed}")
    if not (same and all(resharded.values()) and resumed):
        raise AssertionError(f"13.3: same {same}, resharded {resharded}, resumed {resumed}")
    out["fsdp"]["ms_per_step"] = _ms_per_step(
        lambda *b: step(params, state, *b), batches[0])
    out["checkpoint"] = {"bytes": written, "save_s": save_s, "restore_s": restore_s,
                         "bit_equal": same, "resharded_bit_equal": resharded,
                         "resumed_step_equal": resumed}
    return out


def _finetune_over_group(dev, root: str, cache: str, workdir: str, ft: dict) -> dict:
    """13.4 `cli finetune` as a process of a world-size-1 NCCL group, then
    finetune_embedder(model_parallel=2) here over [cuda:0, cuda:0]."""
    import types

    from eioku_tpu_torch.db.connection import Database
    from eioku_tpu_torch.models.embed.minilm import load_minilm
    from eioku_tpu_torch.parallel import mesh as mesh_mod
    from eioku_tpu_torch.parallel.finetune import finetune_embedder

    one_loss = ft["stats"]["first_loss"]
    out_cache = os.path.join(workdir, "finetuned_pg")
    save_to = os.path.join(out_cache, "minilm-l6", "native.npz")
    cfg_path = os.path.join(workdir, "finetune.json")
    env = {**_service_env(), "EIOKU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "EIOKU_NUM_PROCESSES": "1", "EIOKU_PROCESS_ID": "0"}
    cmd = [sys.executable, "-m", "eioku_tpu_torch.cli", "--db", f"sqlite:///{root}/s.db",
           "--config", cfg_path, "finetune", "--steps", str(PG_STEPS), "--batch-size",
           str(FINETUNE_BATCH), "--model-parallel", "1", "--save-to", save_to]
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                       text=True, capture_output=True, timeout=600)
    wall = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"cli finetune over the group: rc {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    stats = json.loads(r.stdout)
    rel = abs(stats["first_loss"] - one_loss) / abs(one_loss)
    _, _, pretrained = load_minilm(out_cache, device=dev)
    log(f"13.4 cli finetune over a world-size-1 NCCL group: mesh {stats['mesh']}, first "
        f"loss {stats['first_loss']!r} against phase 11's {one_loss!r} (relative "
        f"{rel:.2e}); the saved checkpoint loads (pretrained {pretrained}); process "
        f"{wall:.2f} s")
    if not rel <= PG_LOSS_RTOL or not pretrained or \
            stats["mesh"] != {"data": 1, "model": 1}:
        raise AssertionError(f"13.4 over the group: {stats}, phase 11 {one_loss}")
    db = Database(f"sqlite:///{root}/s.db")
    saved = mesh_mod.local_devices
    mesh_mod.local_devices = lambda device=None: [dev, dev]
    try:
        tp = finetune_embedder(types.SimpleNamespace(
            db=db, config=types.SimpleNamespace(model_cache_dir=cache)), steps=TRAIN_STEPS,
            batch_size=FINETUNE_BATCH, model_parallel=2, device=dev,
            save_to=os.path.join(workdir, "finetuned_tp", "native.npz"))
    finally:
        mesh_mod.local_devices = saved
        db.close()
    tp_rel = abs(tp["first_loss"] - one_loss) / abs(one_loss)
    log(f"13.4 finetune_embedder(model_parallel=2) over [{dev}, {dev}]: mesh "
        f"{tp['mesh']}, first loss relative {tp_rel:.2e} to one device's")
    if not tp_rel <= TRAIN_LOSS_RTOL or tp["mesh"] != {"data": 1, "model": 2}:
        raise AssertionError(f"13.4 model_parallel 2: {tp}")
    return {"process_group": {"stats": stats, "first_loss_rel_err": rel,
                              "process_s": wall},
            "model_parallel_2": {"stats": tp, "first_loss_rel_err": tp_rel}}


def _dp_detect_over_group(dev, workdir: str) -> dict:
    """13.5 DataParallelDetector over the data axis of a world-size-1 NCCL
    group on the clip's 64 frames: outputs and rows equal the plain
    detect's."""
    import torch
    import torch.distributed as dist

    from eioku_tpu_torch.ml import detection, video_io
    from eioku_tpu_torch.models.yolo.classes import COCO_CLASSES
    from eioku_tpu_torch.models.yolo.model import YOLOv8, YoloConfig, fold_batchnorm
    from eioku_tpu_torch.models.yolo.postprocess import detect
    from eioku_tpu_torch.ops import _cuda
    from eioku_tpu_torch.parallel.inference import DataParallelDetector
    from eioku_tpu_torch.parallel.mesh import Mesh

    clip = os.path.join(workdir, "clip.mp4")
    batch = next(iter(video_io.iter_frame_batches(clip, batch_size=64, frame_interval_s=1.0)))
    host, _, _ = detection.letterbox_batch(batch.frames, batch.valid)
    frames = torch.from_numpy(host).to(dev)
    model = fold_batchnorm(YOLOv8(YoloConfig("yolov8n"),
                                  generator=torch.Generator().manual_seed(0))).to(dev).eval()
    want = detect(model, frames, conf_threshold=0.5)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        dp = DataParallelDetector(model, Mesh.over_process_group(dev, axis="data"))
        _cuda.reset_launch_counts()
        got = dp(frames, conf_threshold=0.5)
        torch.cuda.synchronize()
        k2 = _cuda.launch_counts()["nms"]
    finally:
        dist.destroy_process_group()
    meta = [(i, 0) for i in range(len(frames))]

    def rows_of(out):
        r: list = []
        detection.emit_boxes(r, detection.fetch(out), meta, 1.0, (0, 0), len(frames),
                             1.0, (detection.INPUT_SIZE,) * 2, 33, COCO_CLASSES)
        return r
    same = all(torch.equal(got[k], want[k]) for k in want)
    rows = rows_of(got) == rows_of(want)
    log(f"13.5 DataParallelDetector over a world-size-1 NCCL group: {len(frames)} frames, "
        f"{k2} K2 launches; keep masks and outputs equal to the plain detect: {same}; "
        f"{len(rows_of(want))} rows, equal: {rows}")
    if not (same and rows and k2 >= 1):
        raise AssertionError(f"13.5: equal {same}, rows {rows}, K2 {k2}")
    return {"frames": len(frames), "k2_launches": k2, "outputs_equal": same,
            "rows_equal": rows, "rows": len(rows_of(want))}


def phase_training(dev, workdir: str, card: str, ft: dict) -> dict:
    """Phase 13: the fine-tune step over data, model and data x model meshes,
    FSDP, sharded checkpoints, the fine-tune over a process group and
    data-parallel detect over one; MiniLM-L6 at full width (phase 5's
    seeded checkpoint), fp32 with TF32 off, batch 16 x 128 tokens. Every
    mesh lists cuda:0 several times, so no time here is a speed-up."""
    import torch

    from eioku_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.join(workdir, "semantic")
    cache = os.path.join(root, "models")
    batches = [[t.to(dev) for t in b] for b in _training_batches(root, cache, TRAIN_STEPS)]
    seconds = {}
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    out, want = _dp_tp_steps(dev, cache, batches)
    seconds["13.1"] = time.perf_counter() - t
    t = time.perf_counter()
    out.update(_fsdp_and_checkpoints(dev, cache, batches, want, workdir))
    seconds["13.2-13.3"] = time.perf_counter() - t
    t = time.perf_counter()
    out["finetune"] = _finetune_over_group(dev, root, cache, workdir, ft)
    seconds["13.4"] = time.perf_counter() - t
    torch.cuda.synchronize()
    out["k3_launches"] = _cuda.launch_counts()["flash_attention"]
    log(f"13 K3 launches on the training paths: {out['k3_launches']} (S = 128 < 512)")
    if out["k3_launches"] != 0:
        raise AssertionError(f"13: K3 launched {out['k3_launches']} times in training")
    t = time.perf_counter()
    out["dp_detect"] = _dp_detect_over_group(dev, workdir)
    seconds["13.5"] = time.perf_counter() - t
    out["seconds"] = seconds
    out["card"] = card
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAILED: torch.cuda.is_available() is false; this smoke run needs a GPU")
        return 2
    try:
        import eioku_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"FAILED: eioku_tpu_torch is not importable ({e}); run from a checkout")
        return 2
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    seconds = {}

    def timed(name: str, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t
            log(f"phase {name}: {seconds[name]:.1f} s")

    timed("1 build", phase_build)
    k1 = timed("2 K1", phase_k1, dev)
    k2 = timed("3 K2", phase_k2, dev)
    k3 = timed("3b K3", phase_k3, dev)
    k4 = timed("3c K4", phase_k4, dev)
    k5 = timed("3d K5", phase_k5, dev)
    timed("4 fp32 references", phase_logits_reference, dev)
    with tempfile.TemporaryDirectory(prefix="eioku_smoke_") as workdir:
        sl = timed("4 visual", phase_slice, dev, workdir)
        wav = os.path.join(workdir, "speech.wav")
        write_speech_wav(wav)
        tr = timed("4b transcription", phase_transcription, dev, wav)
        dec = timed("4c production decode", phase_production_decode, dev, wav)
        vs_cpu = timed("4d card vs CPU", phase_card_vs_cpu, dev, wav, workdir)
        wk = timed("4e worker", phase_worker, dev, workdir,
                   os.path.join(workdir, "clip.mp4"), wav, sl["cpu_scenes"], card)
        sem = timed("5 semantic", phase_semantic, dev, workdir, card)
        ocr = timed("6 OCR", phase_ocr, dev, workdir, card)
        clip = timed("7 CLIP", phase_clip, dev, workdir, card)
        audio = timed("8 audio", phase_audio, dev, wav, workdir, card)
        api = timed("9 API", phase_api, dev, workdir, card)
        det = timed("10 detection options", phase_detection_options, dev, workdir, card)
        ft = timed("11 fine-tune", phase_finetune, dev, workdir, card)
        md = timed("12 multi-device", phase_multi_device, dev, wav, workdir, card)
        tr13 = timed("13 multi-device training", phase_training, dev, workdir, card, ft)
    kernels = [
        {"name": "scene_diff", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/scene_diff.cu",
         "replaces": "eioku_tpu/ops/scene_diff.py:32",
         "launches": sl["launches"]["scene_diff"],
         "launches_with_ocr": ocr["visual_analysis"]["launches"]["scene_diff"],
         "launches_through_worker": wk["launches"]["scene_diff"],
         "launches_through_api_upload": api["upload"]["launches"]["scene_diff"], **k1},
        {"name": "nms_keep", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/nms.cu",
         "replaces": "eioku_tpu/ops/nms.py:30",
         "launches": sl["launches"]["nms"],
         "launches_with_ocr": ocr["visual_analysis"]["launches"]["nms"],
         "launches_through_worker": wk["launches"]["nms"],
         "launches_through_api_upload": api["upload"]["launches"]["nms"], **k2,
         "on_face_candidates": sl["k2_faces"], "on_object_candidates": sl["k2_objects"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/flash_attention.cu",
         "replaces": "eioku_tpu/ops/flash_attention.py:27",
         "launches": tr["launches"]["flash_attention"],
         "launches_through_worker": wk["transcription_launches"]["flash_attention"],
         "launches_per_minilm_call_s512": sem["models"]["s512"]["k3_launches_bfloat16"],
         "launches_on_indexing_path": sem["index"]["k3_launches_indexing"],
         "minilm_s512_ms_per_call": sem["models"]["s512_bf16_ms_per_call"],
         "launches_turbo_int8": audio["int8_transcription"]["int8"]["k3_launches"],
         "launches_turbo_bf16": audio["int8_transcription"]["bfloat16"]["k3_launches"],
         "launches_speculative_batch": audio["whisper_options"]["draft_model"]["k3_launches"],
         "launches_f16_transcription": tr["float16"]["k3_launches"],
         "launches_tp2_encoder": md["encoders"]["tp2"]["bf16"]["k3_launches"],
         "launches_tp4_encoder": md["encoders"]["tp4"]["bf16"]["k3_launches"],
         "launches_pp_encoder": md["encoders"]["pp"]["bf16"]["k3_launches"],
         "launches_tp_transcription": md["tp_task"]["k3_launches"],
         "launches_training": tr13["k3_launches"],
         "tp_heads": md["k3_tp_heads"],
         **k3},
        {"name": "decode_attention", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/decode_attention.cu",
         "replaces": None,  # the JAX package leaves decoder attention outside any kernel
         "launches": tr["launches"]["decode_attention"], **k4},
        {"name": "add_layer_norm", "route": "cuda",
         "source": "eioku_tpu_torch/csrc/add_layer_norm.cu",
         "replaces": None,  # the JAX package leaves the decoder's layer norms to XLA
         "launches": tr["launches"]["add_layer_norm"], **k5},
    ]
    kernels[1]["launches_data_parallel_two_replicas"] = \
        det["data_parallel"]["two_replicas"]["k2_launches"]
    kernels[1]["launches_visual_int8"] = det["tasks"]["visual_analysis_int8"]["launches"]["nms"]
    kernels[1]["launches_data_parallel_process_group"] = tr13["dp_detect"]["k2_launches"]
    kernels[0]["launches_visual_int8"] = \
        det["tasks"]["visual_analysis_int8"]["launches"]["scene_diff"]
    print(json.dumps({"slice": {k: v for k, v in sl.items()
                                if k not in ("launches", "k2_faces", "k2_objects",
                                             "cpu_scenes")}}))
    print(json.dumps({"transcription": {k: v for k, v in tr.items() if k != "launches"},
                      "production_decode": dec, "card_vs_cpu": vs_cpu}))
    print(json.dumps({"worker": wk}))
    print(json.dumps({"semantic": sem}))
    print(json.dumps({"ocr": ocr, "clip": clip}))
    print(json.dumps({"audio": audio}))
    print(json.dumps({"api": api}))
    print(json.dumps({"detection_options": det, "finetune": ft}))
    print(json.dumps({"multi_device": md}))
    print(json.dumps({"training": tr13}))
    print(json.dumps({"phase_seconds": seconds}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # any failed phase fails the run, with its traceback
        import traceback

        traceback.print_exc()
        log(f"FAILED: {type(e).__name__}: {e}")
        code = 1
    sys.exit(code)
