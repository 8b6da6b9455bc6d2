"""rtvqa_tpu — accelerator-native real-time video complexity & quality analysis.

A ground-up JAX/XLA rebuild of the capabilities of
``zaki699/Real-Time-Video-Quality-Analysis`` (see SURVEY.md): per-clip
CRF re-encode, full-reference quality metrics (PSNR / SSIM / VMAF) and an
eight-metric scene-complexity suite, computed on-device over frame batches
resident in device memory, exponentially smoothed, and appended as one CSV row per clip.

Layer map (device-first redesign of reference layers L1-L7, SURVEY.md §1):

* ``cli``       — L7: ``rtvqa <config.json> <video>`` entry point.
* ``pipeline``  — L6: orchestrator (encode → analyze → CSV row), multi-clip sweep.
* ``metrics``   — L4/L5: complexity + quality suites as pure jitted functions.
* ``vmaf``      — native VIF/ADM/motion feature extraction + SVR predictor.
* ``ops``       — JAX compute primitives (DCT, histograms, edges, motion,
                  FAST+BRIEF, EWM-as-scan, color conversion, resize).
* ``io``        — L2: native C++ (libavcodec) decode/encode/probe, single-pass
                  frame ingestion into batched device tensors.
* ``parallel``  — L3 equivalent: device mesh, shard_map sharding, halo exchange.
* ``config``    — L1: JSON config schema (superset of reference config.json).
* ``obs``       — L1: logging / profiling / progress.
"""

__version__ = "0.1.0"
