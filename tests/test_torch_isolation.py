"""vvc_torch stands alone: after importing it and running a tiny CPU
encode, no JAX module and no module of the JAX package `vvc` is loaded;
and the entry point, given no device, asks for CUDA and raises where
CUDA is absent instead of falling back to the CPU."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, sys
import torch
import vvc_torch
from vvc_torch.enc.encoder import encode_sequence
from vvc_torch.io.synth import synth_frame
from vvc_torch import ops
frames = [synth_frame(64, 64, t) for t in range(2)]
bs, recons, _ = encode_sequence(frames, qp=32, lossless=True, device="cpu")
ok = all((f.y == r.y).all() for f, r in zip(frames, recons))
raised = None
if not torch.cuda.is_available():
    try:
        encode_sequence(frames, qp=32, lossless=True)
    except RuntimeError as e:
        raised = str(e)
print(json.dumps({
    "mods": sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "vvc")),
    "bytes": len(bs), "ok": ok, "raised": raised,
    "counts": ops.COUNTS, "cuda": torch.cuda.is_available()}))
"""


def test_port_imports_no_jax_and_no_vvc():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["mods"] == []
    assert res["ok"] and res["bytes"] > 0
    # CPU tensors take the plain versions: no kernel launch is counted
    assert res["counts"] == {"ref_lines": 0, "intra_pred_all": 0, "satd": 0}
    if res["raised"] is not None or not res["cuda"]:
        assert res["raised"] and "CUDA is not available" in res["raised"]
