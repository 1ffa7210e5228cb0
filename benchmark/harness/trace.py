"""What a `--trace 1` run records: spans around the program's functions,
wrapped where their callers look them up (the program is not edited), the
digits each MSM is given, and a torch.profiler trace of the card over the
window."""
import subprocess
import time
from collections import defaultdict

# span name -> (module of the caller's lookup, attribute)
SPANS = {
    "prepare": ("bulletproof_gadgets_tpu_torch.lang.batch", "prove_prepared"),
    "image_hash": ("bulletproof_gadgets_tpu_torch.lang.batch",
                   "warm_image_cache"),
    "ipa": ("bulletproof_gadgets_tpu_torch.ops.ipa_fused", "create_batched"),
}
MSM_ENTRY = ("bulletproof_gadgets_tpu_torch.ops.msm_serial", "window_sums_t")


class Recorder:
    """Spans (time.time_ns() pairs, the profiler's clock) and MSM digits,
    kept only while `active`."""

    def __init__(self):
        self.spans = defaultdict(list)
        self.msm_calls = []         # (vectors k, points n, device count)
        self.active = False
        self._restore = []
        self._depth = 0

    def install(self):
        import importlib
        from metrics import roofline
        module = importlib.import_module(MSM_ENTRY[0])
        if module.W != roofline.WINDOWS:
            # the roofline counts signed digits of c = 8 windows; digits of
            # another width would count other work
            raise RuntimeError(
                f"{MSM_ENTRY[0]}.W is {module.W}, the roofline's count "
                f"reads {roofline.WINDOWS} windows of c = {roofline.C}")
        for name, (mod, attr) in SPANS.items():
            module = importlib.import_module(mod)
            self._wrap(module, attr, self._span(name, getattr(module, attr)))
        module = importlib.import_module(MSM_ENTRY[0])
        self._wrap(module, MSM_ENTRY[1],
                   self._msm(getattr(module, MSM_ENTRY[1])))

    def uninstall(self):
        for module, attr, orig in reversed(self._restore):
            setattr(module, attr, orig)
        self._restore = []

    def _wrap(self, module, attr, fn):
        self._restore.append((module, attr, getattr(module, attr)))
        setattr(module, attr, fn)

    def _span(self, name, orig):
        def wrapped(*args, **kwargs):
            if not self.active:
                return orig(*args, **kwargs)
            t0 = time.time_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                self.spans[name].append((t0, time.time_ns()))
        return wrapped

    def _msm(self, orig):
        import torch
        from metrics import roofline

        def wrapped(digits_t, *args, **kwargs):
            # an MSM of more vectors than one launch takes calls itself
            # once per group: count the outermost call only
            if self.active and self._depth == 0:
                k, rem = divmod(digits_t.shape[0], roofline.WINDOWS)
                if rem:
                    raise RuntimeError(
                        f"an MSM's {digits_t.shape[0]} digit rows are not "
                        f"{roofline.WINDOWS} windows a vector")
                self.msm_calls.append(
                    (k, digits_t.shape[1], torch.count_nonzero(digits_t),
                     torch.aminmax(digits_t)))
            self._depth += 1
            try:
                return orig(digits_t, *args, **kwargs)
            finally:
                self._depth -= 1
        return wrapped

    def msm_digits(self):
        """[(k, n, non-zero signed digits)] of the MSMs in the window;
        raises where a digit lies outside the signed c = 8 range."""
        from metrics import roofline
        out = []
        for k, n, c, (lo, hi) in self.msm_calls:
            if int(lo) < -roofline.BUCKETS or int(hi) > roofline.BUCKETS:
                raise RuntimeError(
                    f"MSM digits in [{int(lo)}, {int(hi)}]: not signed "
                    f"digits of c = {roofline.C}")
            out.append((k, n, int(c)))
        return out


def device_activity(events):
    """(busy seconds, [(start_ns, end_ns)] merged, {name: seconds}) of the
    card's kernels, copies and memsets: busy time is the union of their
    intervals, so overlap counts once."""
    spans, by_name = [], defaultdict(float)
    for name, start, end in events:
        spans.append((start, end))
        by_name[name] += (end - start) / 1e9
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    busy = sum(e - s for s, e in merged) / 1e9
    return busy, merged, dict(by_name)


class DeviceProfile:
    """A kineto trace of the card's kernels, copies and memsets (no host
    operators), stopped without torch.profiler's own processing of every
    event into a tree: a window of the device sponge holds ~10^6 launches,
    which that processing takes minutes over."""

    def __init__(self, on_card):
        from torch.autograd import profiler
        self._profile = profiler.profile(
            use_device="cuda" if on_card else None, use_cpu=not on_card,
            use_kineto=True)
        self.result = None

    def start(self):
        self._profile.__enter__()

    def stop(self):
        import torch
        from torch.autograd import _disable_profiler, profiler
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.result = _disable_profiler()
        stop_hooks = getattr(profiler, "_run_on_profiler_stop", None)
        if stop_hooks is not None:
            stop_hooks()

    def device_events(self):
        """[(name, start_ns, end_ns)] of the device-side events."""
        from torch.autograd import DeviceType
        cuda = DeviceType.CUDA
        return [(e.name(), e.start_ns(), e.end_ns())
                for e in self.result.events() if e.device_type() == cuda]


def idle_gaps(merged, t0, t1, spans):
    """Idle time of the card inside [t0, t1], by the innermost span running
    on the host at each gap's middle -> {label: seconds}."""
    gaps, reach = [], t0
    for s, e in merged:
        if s > reach:
            gaps.append((reach, min(s, t1)))
        reach = max(reach, e)
    if reach < t1:
        gaps.append((reach, t1))
    flat = sorted((s, e, name) for name, lst in spans.items()
                  for s, e in lst)
    out = defaultdict(float)
    for s, e in gaps:
        if e <= s:
            continue
        mid = (s + e) // 2
        inner = [(se - ss, name) for ss, se, name in flat
                 if ss <= mid < se]
        out["host: " + (min(inner)[1] if inner else "outside the spans")] += \
            (e - s) / 1e9
    return dict(out)


def gpu_state(index=0):
    """nvidia-smi's reading of the card: {name: value}, or {} where it
    cannot read."""
    fields = ["clocks.sm", "clocks.max.sm", "power.limit", "power.draw"]
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return {f: float(v) for f, v in zip(fields, out.strip().split(","))}
    except (OSError, subprocess.SubprocessError, ValueError):
        return {}
