"""Render the smoke gate's CPU frames with the port (twin of the
repository's tools/make_smoke_goldens.py).

    python -m raytracer_project_tpu_torch.tools.make_smoke_goldens OUT_DIR

Renders the stages' images (utils/smoke.py render_fused_fast,
render_fused_features, render_pool) with the kernels' plain versions on
the CPU, prints each one's difference from the committed CPU golden in
tests/goldens/, and writes OUT_DIR/<name>.npz. The committed goldens are
the JAX package's renders and stay the semantic reference: the tool
refuses an OUT_DIR inside tests/goldens/ or raytracer_project_tpu/.
The 128x72 pool frame takes about 85 s on two CPU threads.
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
    from ..utils import smoke

    for render in (smoke.render_fused_fast, smoke.render_fused_features,
                   smoke.render_pool):
        for name, _label, _max_frac, img in render("cpu"):
            goldens.write_golden(out, name, img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
