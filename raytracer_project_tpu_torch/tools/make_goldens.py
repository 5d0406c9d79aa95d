"""Render the scene goldens' frames with the port (twin of the
repository's tools/make_goldens.py).

    python -m raytracer_project_tpu_torch.tools.make_goldens OUT_DIR

Renders the four configurations of tests/goldens/ (tools/goldens.py
golden_config: showcase, shirley, cornell, hdri; chunked, seed 0) with the
kernels' plain versions on the CPU, prints each one's difference from the
committed golden, and writes OUT_DIR/<name>.npz. The committed goldens
stay the reference: the tool refuses an OUT_DIR inside tests/goldens/ or
raytracer_project_tpu/.
"""

from __future__ import annotations

import argparse
import sys

from . import goldens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="directory to write the npz files into")
    args = ap.parse_args(argv)
    out = goldens.writable_dir(args.out)
    from ..ops import integrator

    for name in goldens.SCENE_GOLDENS:
        scene, cam, env, cfg = goldens.golden_config(name)
        img = integrator.render(scene, cam, env, 0, cfg, device="cpu")
        goldens.write_golden(out, name, img["beauty"].numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
