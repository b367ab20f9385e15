"""Whether an nvcc flag of the port's build changes the kernels it makes.

    python3 tools/torch_build_flags_probe.py [--without=FLAG] [--time]
                                             [--out DIR]

Compiles every openhush_tpu_torch/csrc/*.cu to an object twice, one nvcc
a source, all started together: once as ops/_build.build does (FLAGS and
the source's SOURCE_FLAGS), once with FLAG (default --split-compile=0)
left out wherever it stands. Prints each set's wall time and each source's
own, then, kernel by kernel, whether the SASS (`cuobjdump -sass`) is the
same and, where it is not, both resource lines (`cuobjdump -res-usage`:
registers, stack, shared and local memory). A kernel whose SASS is the
same runs the same instructions, so the flag cannot change its time.
Needs nvcc and cuobjdump (the CUDA toolkit); no GPU without --time.

--time (one GPU) links each set into a library and runs chip_smoke.py's
phases of decode_attention.cu's kernels (K4 and K5 at the serving step's
shapes, the int8 self-cache, beam, speculative and multi-query modes) on
each in turns (as built, without, without, as built): every time those
phases take, the two sets' best beside each other. The last line is a
JSON summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from openhush_tpu_torch.ops import _build  # noqa: E402


def compile_all(flags_of, out: Path):
    """Every source to out/<stem>.o at once, with flags_of(src); (wall s,
    {stem: s})."""
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    pending = {}
    for src in _build._sources():
        with open(out / f"{src.stem}.log", "w") as log:
            pending[src.stem] = subprocess.Popen(
                _build.compile_command(src, out / f"{src.stem}.o", "-c",
                                       flags=flags_of(src)),
                stdout=log, stderr=subprocess.STDOUT)
    each = {}
    while pending:
        for stem, p in list(pending.items()):
            if p.poll() is not None:
                each[stem] = time.monotonic() - t0
                if p.returncode:
                    raise RuntimeError(f"nvcc failed for {stem}: see "
                                       f"{out / (stem + '.log')}")
                del pending[stem]
        time.sleep(0.05)
    return time.monotonic() - t0, each


def per_function(tool: str, obj: Path, option: str, header: str):
    """cuobjdump `option` of obj split by kernel: {name: text}."""
    text = subprocess.run([tool, option, str(obj)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(header, line.strip())
        if m:
            name = m.group(1)
            out[name] = [line.strip()[m.end():].strip()]
        elif name is not None:
            out[name].append(line.strip())
    return {k: "\n".join(v).strip() for k, v in out.items()}


def times_of(obj, path="") -> dict:
    """Every "ms" in a phase's rows (dicts, lists of them), by its place."""
    out = {}
    if isinstance(obj, dict):
        path += "/" + ",".join(f"{k}={obj[k]}" for k in (
            "name", "what", "mode", "dtype", "B", "G", "K", "S", "T", "M")
            if k in obj)
        if isinstance(obj.get("ms"), float):
            out[path] = obj["ms"]
        for k, v in obj.items():
            if isinstance(v, (dict, list)):
                out.update(times_of(v, f"{path}/{k}"))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(times_of(v, f"{path}[{i}]"))
    return out


def time_sets(out: Path, sets) -> dict:
    """decode_attention.cu's phases of chip_smoke.py on each set's library,
    in turns; {set: {place: [ms, ms]}}."""
    import chip_smoke
    from openhush_tpu_torch.ops import decode_attention as da, quantize
    libs = {}
    for which in sets:
        so = out / which / "lib.so"
        subprocess.run([_build.nvcc(), *_build.ARCH, "-shared",
                        *map(str, sorted((out / which).glob("*.o"))), "-o",
                        str(so)], check=True)
        libs[which] = _build.load(so)
    phases = (chip_smoke.phase_decode_attention,
              chip_smoke.phase_int8_self_cache,
              chip_smoke.phase_beam_attention,
              chip_smoke.phase_spec_attention,
              chip_smoke.phase_multi_attention)
    order = list(sets) + list(sets)[::-1]
    times = {w: {} for w in sets}
    for which in order:
        _build._lib = libs[which]
        for phase in phases:
            got = times_of(phase(da, quantize), phase.__name__)
            for place, ms in got.items():
                times[which].setdefault(place, []).append(ms)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--without", default="--split-compile=0")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "flags_probe"))
    args = ap.parse_args(argv)
    as_built = lambda src: _build.FLAGS + _build.SOURCE_FLAGS.get(src.name,
                                                                  [])
    if not any(args.without in as_built(src) for src in _build._sources()):
        print(f"{args.without} is in neither _build.FLAGS nor SOURCE_FLAGS")
        return 2
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    out = Path(args.out)
    sets = {"as built": as_built,
            "without": lambda src: [f for f in as_built(src)
                                    if f != args.without]}
    times = {}
    for which, flags_of in sets.items():
        wall, each = compile_all(flags_of, out / which)
        times[which] = wall
        print(f"{which}: {len(each)} sources in {wall:.1f} s wall; "
              + ", ".join(f"{k} {v:.1f} s" for k, v in
                          sorted(each.items(), key=lambda kv: -kv[1])),
              flush=True)
    summary = {"flag": args.without, "build_s": times, "kernels": 0,
               "same_sass": 0, "differ": []}
    for src in _build._sources():
        objs = {w: out / w / f"{src.stem}.o" for w in sets}
        sass = {w: per_function(cuobjdump, o, "-sass", r"Function : (\S+)")
                for w, o in objs.items()}
        res = {w: per_function(cuobjdump, o, "-res-usage",
                               r"Function (\S+):") for w, o in objs.items()}
        names = sorted(set(sass["as built"]) | set(sass["without"]))
        same = [n for n in names
                if sass["as built"].get(n) == sass["without"].get(n)]
        summary["kernels"] += len(names)
        summary["same_sass"] += len(same)
        print(f"{src.name}: {len(names)} kernels, SASS the same in "
              f"{len(same)}", flush=True)
        for n in names:
            if n in same:
                continue
            summary["differ"].append(n)
            print(f"  differs: {n}")
            for w in sets:
                lines = len(sass[w].get(n, "").splitlines())
                print(f"    {w}: {res[w].get(n, 'absent')}; {lines} SASS "
                      f"lines")
    if args.time:
        t = time_sets(out, sets)
        ratios = []
        print("decode_attention.cu's phases, ms (best of two turns), as "
              "built / without:")
        for place, a in t["as built"].items():
            b = t["without"].get(place)
            if not b or min(b) <= 0:
                continue
            ratios.append(min(a) / min(b))
            print(f"  {place}: {min(a):.5f} / {min(b):.5f} = "
                  f"{ratios[-1]:.4f}  (turns {a} / {b})")
        geo = math.exp(sum(map(math.log, ratios)) / len(ratios))
        summary.update(timed=len(ratios), ratio_geomean=geo,
                       ratio_min=min(ratios), ratio_max=max(ratios))
    summary["differ"] = len(summary["differ"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
