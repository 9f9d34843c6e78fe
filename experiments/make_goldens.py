"""Generate and check in low-res goldens for all six scene presets, plus
scene 3's golden (missing upstream — the generation branch is dead code,
SURVEY quirk 3 / Reference.cpp:566-671).

Writes reference/<id>/low.exr (192x108 64-bounce MC, GOLDEN_FRAMES
accumulated frames) for every preset, and reference/3/0.exr as scene 3's
canonical golden.  The goldens are of the WDAS cloud: the VDB must be at
data/volume/wdas_cloud_sixteenth.vdb.  The checked-in set used 256 frames
for low.exr (plenty for the pooled mean-brightness tests; per-pixel noise
~CV/16) and 1024 for scene 3's canonical 0.exr.

    python experiments/make_goldens.py [scene ids...]
"""
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: F401

from nrc_hpm.utils.compile_cache import enable_compilation_cache

enable_compilation_cache()

from nrc_hpm.config import AppConfig, SceneConfig
from nrc_hpm.reference import generate_golden

W, H = 192, 108
FRAMES = int(os.environ.get("GOLDEN_FRAMES", "256"))


def main():
    scenes = [int(a) for a in sys.argv[1:]] or list(range(6))
    for sid in scenes:
        cfg = AppConfig(scene=SceneConfig.preset(sid))
        out = f"reference/{sid}/low.exr"
        print(f"scene {sid}: {FRAMES} frames of 64-bounce MC at {W}x{H} "
              f"-> {out}", flush=True)
        generate_golden(cfg, out, frames=FRAMES, path_length=64,
                        width=W, height=H, seed=0,
                        progress_every=64)
        if sid == 3:
            shutil.copyfile(out, "reference/3/0.exr")
            print("scene 3: low.exr promoted to 0.exr (canonical golden)",
                  flush=True)


if __name__ == "__main__":
    main()
