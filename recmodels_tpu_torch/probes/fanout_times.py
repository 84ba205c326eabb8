"""The fused-row fanout (#2, ``split_fused_rows``) and its backward (#6) on
this card at the batches the main path gives them: a served request of 1,
1,000 or 4,096 examples and the flagship batch of 16,384 (26 slots, dim 16).

    python -m recmodels_tpu_torch.probes.fanout_times     # one NVIDIA GPU

For bf16 and f32 rows it checks both kernels bit for bit against their plain
versions (wide_sum within 1e-5 of max(|ref|, 1)) and times them warm by
torch.profiler over back-to-back calls and with a cold L2 (a 2 GiB write
before each call), at 16,384 beside the plain versions and #6's one-call
equivalent, ``torch.cat``. It times the package it is imported from, so a
patched copy of the package (another group size, say) is timed by its own
copy of this file. It prints the card's name and power limit and, last, one
JSON line of the times in ms. The port never calls it.
"""

from __future__ import annotations

import json
import subprocess

import torch

from recmodels_tpu_torch.ops.cuda import interactions_cuda as K
from recmodels_tpu_torch.probes.sparse_update_rows import warm_ms

M, D = 26, 16
BATCHES = (1, 1000, 4096, 16384)


def cold_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn`` by CUDA events, the L2 evicted before each."""
    flush = torch.empty(2**29, dtype=torch.float32, device="cuda")
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(calls)]
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / calls


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("fanout_times: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {}
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        b = max(BATCHES)
        full = (torch.randn((b, M, D + 1), generator=gen, device=dev) * 0.05).to(dt)
        g_dm = torch.randn((b, D, M), generator=gen, device=dev).to(dt)
        g_ws = torch.randn((b,), generator=gen, device=dev)
        x_dm, ws = K.split_fused_rows(full, D)
        x_ref, ws_ref = K.split_fused_rows_reference(full, D)
        ws_err = (ws - ws_ref).abs().max().item()
        if not torch.equal(x_dm, x_ref) or ws_err > 1e-5 * max(ws_ref.abs().max().item(), 1.0):
            raise RuntimeError(f"fanout_times: split_fused_rows {tag} disagrees with its plain version")
        if not torch.equal(K.split_fused_rows_backward(g_dm, g_ws),
                           K.split_fused_rows_backward_reference(g_dm, g_ws)):
            raise RuntimeError(f"fanout_times: split_fused_rows_backward {tag} disagrees with its plain version")
        timed = {}
        for n in BATCHES:
            timed[f"fwd b{n}"] = lambda n=n: K.split_fused_rows(full[:n], D)
            timed[f"bwd b{n}"] = lambda n=n: K.split_fused_rows_backward(g_dm[:n], g_ws[:n])
        timed[f"fwd plain b{b}"] = lambda: K.split_fused_rows_reference(full, D)
        timed[f"bwd plain b{b}"] = lambda: K.split_fused_rows_backward_reference(g_dm, g_ws)
        timed[f"bwd torch.cat b{b}"] = lambda: torch.cat(
            (g_dm.transpose(1, 2), g_ws.to(dt)[:, None, None].expand(b, M, 1)), 2)
        for name, fn in timed.items():
            key = f"{tag} {name}"
            result[key] = {"warm": warm_ms(fn), "cold": cold_ms(fn)}
            print(f"{key}: {result[key]['warm']:.4f} ms warm, {result[key]['cold']:.4f} ms cold on {card}",
                  flush=True)
        del full, g_dm, g_ws, x_dm, ws, x_ref, ws_ref
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
