"""Where the port's orbax reader (``lasr_tpu_torch/utils/ocdbt.py``) spends a
full-width read, on the machine with the card (host time; no kernel runs).

    python3 profile_torch_orbax_read.py            # a synthetic 0.74 GB tree
    python3 profile_torch_orbax_read.py --phase    # chip_smoke's orbax phase

The default writes a tree of seeded float32 arrays of the recipe model's
shapes (0.74 GB, as one step of its train state) with ``save_tree``, reads
it three times with ``load_tree``, times the store's value reads (into a
reused buffer and into fresh ones) and a fill of as many fresh arrays of
the same sizes, all kept alive (what writing a read's result costs in
page faults), then prints a cProfile of one more read by internal time.  ``--phase`` runs chip_smoke.py's device, build and
orbax phases with the first read of a whole step profiled the same way.
"""

import argparse
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lasr_tpu_torch.utils import ocdbt  # noqa: E402

SHAPES = [(320, 1280), (1280, 320), (320, 320), (320,), (1280,), (640, 320),
          (5000, 320), (5000,)]
STEP_BYTES = 0.74e9


def profiled(fn, *args):
    pr = cProfile.Profile()
    t = time.perf_counter()
    pr.enable()
    out = fn(*args)
    pr.disable()
    print(f"profiled {fn.__name__}: {time.perf_counter() - t:.3f} s",
          flush=True)
    text = io.StringIO()
    pstats.Stats(pr, stream=text).sort_stats("tottime").print_stats(14)
    print(text.getvalue()[-4000:], flush=True)
    return out


def synthetic() -> None:
    rng = np.random.default_rng(0)
    tree, nbytes, i = {}, 0, 0
    while nbytes < STEP_BYTES:
        a = rng.standard_normal(SHAPES[i % len(SHAPES)], dtype=np.float32)
        tree.setdefault(f"p{i // 40}", {})[f"w{i}"] = a
        nbytes += a.nbytes
        i += 1
    print(f"{i} arrays, {nbytes / 1e9:.3f} GB", flush=True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tree")
        t = time.perf_counter()
        ocdbt.save_tree(path, tree)
        print(f"save_tree: {time.perf_counter() - t:.3f} s", flush=True)
        for _ in range(3):
            t = time.perf_counter()
            ocdbt.load_tree(path)
            print(f"load_tree: {time.perf_counter() - t:.3f} s", flush=True)
        with ocdbt.OcdbtStore(path) as store:
            keys = [k for k in store.keys() if not k.endswith(".zarray")]
            for slot, label in ((0, "into a reused buffer"),
                                (None, "into fresh buffers")):
                t = time.perf_counter()
                for k in keys:
                    store.read(k, slot)
                print(f"value reads {label}: "
                      f"{time.perf_counter() - t:.3f} s", flush=True)
        t = time.perf_counter()
        kept = [np.empty(a.shape, np.float32) for part in tree.values()
                for a in part.values()]
        for a in kept:      # kept alive, as a read's result is: fresh pages
            a.fill(1)
        print(f"fill of fresh arrays: {time.perf_counter() - t:.3f} s",
              flush=True)
        del kept
        profiled(ocdbt.load_tree, path)


def phase() -> None:
    import chip_smoke as cs
    load_tree, done = ocdbt.load_tree, []

    def first_step_profiled(path, top=None):
        step = os.path.join("last", "2", "default")
        if done or top is not None or not path.endswith(step):
            return load_tree(path, top)
        done.append(path)
        return profiled(load_tree, path)
    ocdbt.load_tree = first_step_profiled
    state = {"seed": 0, "kernels": {}, "launches": {}, "timings": {},
             "card": "not measured"}
    for name in ("device", "build", "orbax"):
        getattr(cs, f"phase_{name}")(state)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="store_true")
    phase() if ap.parse_args().phase else synthetic()
