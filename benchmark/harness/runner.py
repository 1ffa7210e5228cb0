"""One run of one cell: set-up and warm-up, the measured window (traced
with --trace 1), then the comparison that decides `correct`."""
import gc
import sys
import time
from types import SimpleNamespace

from . import check, faults, trace
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "bulletproof_gadgets_tpu")


class Port:
    """The system under test: the port's public entries and what the
    check reads of its state (the MiMC image cache)."""

    def __init__(self):
        from bulletproof_gadgets_tpu_torch.lang import batch, verify
        from bulletproof_gadgets_tpu_torch.models import mimc
        from bulletproof_gadgets_tpu_torch.utils import rng
        self.batch_module = batch
        self.prove_batch = batch.prove_batch
        self.verify = verify.verify
        self.image_cache = mimc._image_cache
        self.rng = rng
        self.restore = []

    def close(self):
        for module, attr, orig in reversed(self.restore):
            setattr(module, attr, orig)
        self.restore = []


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def require_cuda(chips):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the benchmark runs on the "
                         "card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")


def _e2e(cell, traffic, reqs, setup_s):
    window = reqs[-1].returned - reqs[0].issued
    work = sum(traffic.done(r) for r in reqs)
    values = {"setup_s": setup_s,
              "proofs_per_s": work / window,
              "verifies_per_s": work / window}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def _per_layer(cell, ctx):
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]](ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell, seed, seconds, traced, t_start, device=None, fault=None,
        requests=None):
    """-> the result dict (README.md).  `device` None means the card (and
    fails without one); `fault` plants one of faults.py's; `requests` runs
    that many requests instead of a timed window."""
    import torch
    if device is None:
        require_cuda(cell.chips)
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    port = Port()
    port.rng.set_seed(f"benchmark/{cell.name}/{seed}")
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    traffic = Traffic(cell, seed, port, device)
    traffic.setup()
    if fault is not None:
        faults.plant(fault, port)
    traffic.warm_up()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    rec = prof = None
    if traced:
        rec = trace.Recorder()
        rec.install()
        prof = trace.DeviceProfile(on_card)
        prof.start()
        rec.active = True
    t0_ns, cpu0 = time.time_ns(), time.process_time()
    reqs = traffic.window(seconds, requests)
    if on_card:
        torch.cuda.synchronize(device)
    t1_ns, cpu1 = time.time_ns(), time.process_time()
    print("request seconds " + " ".join(
        f"{r.returned - r.issued:.3f}" for r in reqs), file=sys.stderr)
    print(f"window {(t1_ns - t0_ns) / 1e9:.3f} s, process CPU "
          f"{cpu1 - cpu0:.3f} s", file=sys.stderr)
    result = {"correct": False, "attempted": len(reqs), "failed": 0}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (
                       torch.cuda.max_memory_allocated(device) if on_card
                       else 0)}
    if traced:
        rec.active = False
        prof.stop()
        rec.uninstall()
        t_read = time.perf_counter()
        ctx, breakdown = _trace_context(cell, traffic, reqs, rec, prof,
                                        t0_ns, t1_ns)
        print(f"trace read {time.perf_counter() - t_read:.1f} s",
              file=sys.stderr)
        prof = None
        device_info["busy_s"] = ctx.busy_s
        device_info["window_s"] = ctx.window_s
        result["metrics"] = _per_layer(cell, ctx)
        result["breakdown"] = breakdown
    else:
        result["metrics"] = _e2e(cell, traffic, reqs, setup_s)
    result["device"] = device_info

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if traffic.kind == "prove_batch":
        numbers, seen = check.check_prove_batch(traffic, reqs, seed, device,
                                                port.image_cache)
    else:
        numbers, seen = check.check_verify(traffic, reqs, seed, device)
    port.close()
    print(f"reference check {time.perf_counter() - t_check:.1f} s over "
          f"{seen}", file=sys.stderr)
    result["failed"] = numbers["requests_failed"]
    result["correct"], result["checks"] = check.judge(numbers)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded that the run may not load: {bad}")
    return result


def _trace_context(cell, traffic, reqs, rec, prof, t0_ns, t1_ns):
    events = [(n, max(s, t0_ns), min(e, t1_ns))
              for n, s, e in prof.device_events()
              if e > t0_ns and s < t1_ns]
    busy, merged, by_name = trace.device_activity(events)
    spans = dict(rec.spans)
    if traffic.kind == "verify":
        spans["verify"] = [(t0_ns + int((r.issued - reqs[0].issued) * 1e9),
                            t0_ns + int((r.returned - reqs[0].issued) * 1e9))
                           for r in reqs]
    gaps = trace.idle_gaps(merged, t0_ns, t1_ns, spans)
    ctx = SimpleNamespace(
        spans=spans, requests=len(reqs),
        work=sum(traffic.done(r) for r in reqs),
        latencies=[r.returned - r.issued for r in reqs],
        busy_s=busy, window_s=(t1_ns - t0_ns) / 1e9, kernels=by_name,
        msm_digits=rec.msm_digits(), gpu=trace.gpu_state())
    _print_msm_bound(ctx)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    breakdown = {
        "device_ops": [[n[:120], s] for n, s in top],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda kv: -kv[1])[:10]}
    return ctx, breakdown


def _print_msm_bound(ctx):
    """The MSM work of the window, which bound applies, and the card's
    clock and power limit, on standard error."""
    from metrics import roofline
    products = nbytes = 0
    for k, n, nz in ctx.msm_digits:
        p, b = roofline.msm_work(k, n, nz)
        products, nbytes = products + p, nbytes + b
    clock = ctx.gpu.get("clocks.max.sm", 0.0)
    if products and clock:
        least, by = roofline.least_seconds(products, nbytes, clock * 1e6)
        print(f"msm work {len(ctx.msm_digits)} MSMs, {products} products, "
              f"{nbytes} bytes: least {least:.6f} s by {by}; kernels "
              f"{roofline.kernel_seconds(ctx.kernels):.6f} s; max SM clock "
              f"{clock} MHz, power limit {ctx.gpu.get('power.limit')} W",
              file=sys.stderr)
