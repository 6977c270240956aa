"""Registers and spills of every kernel of two checkouts, side by side.

    python3 ptxas_compare.py PARENT_DIR CHANGE_DIR OUT.json

Builds ``elektronn3_tpu_torch/csrc`` of both checkouts (each with its own
``_build.py``, in parallel) with ``-Xptxas=-v`` and holds every kernel
of the first against the same kernel of the second: registers, stack
frame, spill stores and spill loads. A kernel that gained a trailing
``false`` template argument (a per-sample flag whose batch form keeps
its name otherwise), or the default ``VdArgs`` type argument of the vup
dgrad, is matched to its parent. Prints the unchanged count, each
changed and unmatched parent kernel and each new kernel; writes the
lists to OUT.json. Needs nvcc (the card's machine); a PR that must keep
the batch forms' code runs it on its parent and itself.
"""

import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path


def _load(root, name):
    """The checkout's ``_build`` module, building into a directory of its
    own (a library already built there keeps no ptxas report)."""
    spec = importlib.util.spec_from_file_location(
        name, Path(root) / "elektronn3_tpu_torch/ops/_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BUILD_DIR = Path(tempfile.mkdtemp(prefix=f"{name}-"))
    return mod


def parse(log):
    """{mangled kernel: {regs, stack, spill_st, spill_ld}} from ptxas."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                            spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["regs"] = int(m.group(1))
    return out


def demangle(names):
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not Path(filt).exists():
        filt = "c++filt"
    res = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True)
    return dict(zip(names, res.stdout.splitlines()))


def candidates(name):
    """The change's names a parent kernel may have: its own, with a
    trailing ``false`` template argument, or with the vup dgrad's default
    argument type (whose parameter then demangles as ``T3``)."""
    return (name, name.replace(">(", ", (bool)0>(", 1),
            name.replace(">(<unnamed>::VdArgs)", ", <unnamed>::VdArgs>(T3)"))


def main(parent, change, out):
    mods = [_load(parent, "build_parent"), _load(change, "build_change")]
    errs = []

    def build(mod):
        try:
            mod.build(verbose=True)
        except Exception as e:   # noqa: BLE001 (reported below)
            errs.append(repr(e))
    threads = [threading.Thread(target=build, args=(m,)) for m in mods]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        sys.exit(f"build failed: {errs[0][-3000:]}")
    logs = [parse(m.build_log) for m in mods]
    names = [demangle(list(log)) for log in logs]
    par = {names[0][k]: v for k, v in logs[0].items()}
    chg = {names[1][k]: v for k, v in logs[1].items()}
    same, diff, missing, matched = 0, [], {}, set()
    for name, v in sorted(par.items()):
        c = next((k for k in candidates(name) if k in chg), None)
        if c is None:
            missing[name] = v
            continue
        matched.add(c)
        if chg[c] == v:
            same += 1
        else:
            diff.append((name, v, chg[c]))
    new = {k: chg[k] for k in sorted(chg) if k not in matched}
    Path(out).write_text(json.dumps(
        {"same": same, "diff": diff, "missing": missing, "new_kernels": new},
        indent=1))
    print(f"ptxas: {same} parent kernels unchanged, {len(diff)} changed, "
          f"{len(missing)} not found; {len(new)} new kernels", flush=True)
    for name, a, b in diff:
        print("CHANGED", name, a, "->", b)
    for name in missing:
        print("NOT FOUND", name)
    for name, v in new.items():
        print("NEW", name, v)


if __name__ == "__main__":
    if len(sys.argv) != 4:
        sys.exit(__doc__)
    main(*sys.argv[1:])
