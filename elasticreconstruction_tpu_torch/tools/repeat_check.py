"""Do two runs of the same stages on the same inputs write the same bytes?

    python -c "from pathlib import Path; from elasticreconstruction_tpu_torch.tools.repeat_check import repeat; \
        print(repeat(Path('DIR'), ['register', 'posegraph'], ['--data', 'D']))"

``DIR`` holds a ``fragments/`` directory (as the ``fragments`` verb writes
it). Each run starts from a copy of it under ``DIR/repeat_<k>`` and runs the
verbs in order through the CLI; then every file the runs wrote is compared
byte for byte. Before that, ``prep_fragments_batch`` runs twice on the
fragment clouds and its outputs are compared bit for bit, since it feeds
everything ``register`` does. :func:`repeat` returns whether each check
matched, and for files that differ, where the first differing line is.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from ..core.types import PointCloud, resolve_device
from ..pipeline import run
from ..pipeline.stages import load_fragment_clouds
from ..registration import prep_fragments_batch


def first_difference(a: Path, b: Path) -> dict | None:
    """None when the files hold the same bytes, else the first line that differs."""
    ta, tb = a.read_bytes(), b.read_bytes()
    if ta == tb:
        return None
    la, lb = ta.splitlines(), tb.splitlines()
    k = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y), min(len(la), len(lb)))
    line = lambda rows: rows[k].decode(errors="replace") if k < len(rows) else None  # noqa: E731
    return {"line": k + 1, "a": line(la), "b": line(lb)}


def prep_repeats(cfg, dev: torch.device) -> bool:
    """``prep_fragments_batch`` twice on the fragment clouds: the same bits?"""
    clouds = load_fragment_clouds(cfg)
    batch = PointCloud(*(np.stack(xs) for xs in zip(*clouds)))
    a, b = (prep_fragments_batch(batch, cfg.registration, device=dev) for _ in range(2))
    flat = lambda p: [*p.coarse, p.features, *p.fine]  # noqa: E731
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


def repeat(out: Path, verbs: list[str], argv: list[str], device: str = "cuda") -> dict:
    """Run ``verbs`` twice from copies of ``out/fragments``; compare what they wrote."""
    dev = resolve_device(device)
    runs = []
    for k in range(2):
        root = out / f"repeat_{k}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(out / "fragments", root / "fragments")
        for verb in verbs:
            if run.main([verb, "--out", str(root), "--device", str(dev), *argv]) != 0:
                raise RuntimeError(f"the {verb} verb returned non-zero")
        runs.append(root)
    names = sorted(str(p.relative_to(runs[0])) for p in runs[0].rglob("*")
                   if p.is_file() and not p.relative_to(runs[0]).parts[0] == "fragments")
    diffs = {}
    for name in names:
        d = first_difference(runs[0] / name, runs[1] / name)
        if d is not None:
            diffs[name] = d
    cfg = run.config_from_args(run.build_parser().parse_args(["register", "--out", str(out), *argv]))
    return {"verbs": verbs, "files": names, "identical": not diffs, "differences": diffs,
            "prep_identical": prep_repeats(cfg, dev)}
