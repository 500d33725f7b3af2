"""CUDA kernel counts of ``local_vol_american_bracket`` at a few (exercise
dates, steps a date), each counted twice, on the sample smile and a flat
surface, plus the direct count at the defaults (25 × 8) on the smile.

Shows that the count is c0 + dates·(m + steps·s) on the card and how many
records a profiler session drops. Needs a CUDA card; run from the repo root:

    PYTHONPATH=. python3 tools/lv_kernel_counts.py
"""
import collections
import time

import torch

from optionslab_tpu_torch.models import local_vol as lvm
from optionslab_tpu_torch.models import local_vol_american as lva

dev = torch.device("cuda")
for name, iv in (("smile", lvm.sample_smile_iv_fn()), ("flat", lambda k, t: 0.2 + 0.0 * k)):
    dup = lvm.DupireLocalVol(iv, 100.0, 0.05, device=dev)

    def f(n, k):
        return lva.local_vol_american_bracket(dup, 100.0, 1.0, n_dates=n, steps_per_date=k,
                                              device=dev)

    f(2, 8)
    torch.cuda.synchronize()
    pts = [(2, 1), (2, 1), (2, 2), (2, 2), (3, 1), (3, 1), (3, 2)]
    for a, b in pts + ([(25, 8)] if name == "smile" else []):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            f(a, b)
            torch.cuda.synchronize()
        c = collections.Counter()
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith(("Memcpy", "Memset"))):
                c[e.key] += e.count
        print(name, a, b, sum(c.values()), f"{time.perf_counter() - t0:.1f} s", flush=True)
