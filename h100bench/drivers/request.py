"""Synchronous requests: one client, closed loop, no think time. Each
request hands ``batch_size`` uint8 frames to ``DepthPipeline.__call__`` and
waits for its depth on the host (``.cpu()``).

Traffic keys: ``batch_size``; ``pool_requests``, the requests drawn from
the pool of frames (``serving.POOL_FRAMES``, frames without replacement in
each), sent in turn, over and over; ``warmup_requests`` at set-up;
``check_batches`` (requests, ``serving.py``); ``trace_lead`` and
``trace_requests``. End to end: ``request_p95_ms``, the 95th percentile of
every request of the window, from the call to the depth on the host.
``attempted`` counts its requests.
"""

from __future__ import annotations

import time

import numpy as np

from h100bench.common import sync
from h100bench.drivers.serving import Reservoir, Server, hooked


class Driver(Server):
    def __init__(self, cell):
        super().__init__(cell)
        rng = cell.rng(1)
        self.requests = [self.pool[np.sort(rng.choice(len(self.pool), self.batch, replace=False))]
                         for _ in range(cell.traffic["pool_requests"])]
        for i in range(cell.traffic["warmup_requests"]):
            self.pipe(self.requests[i % len(self.requests)]).cpu()

    def window(self, seconds: float):
        latencies, enqueue = [], []
        sampler = Reservoir(self.cell.traffic["check_batches"], self.cell.rng(3))
        n = 0
        t0 = time.perf_counter()
        while True:
            frames = self.requests[n % len(self.requests)]
            ts = time.perf_counter()
            out = self.pipe(frames)
            te = time.perf_counter()
            depth = out.cpu().numpy()
            tf = time.perf_counter()
            latencies.append(tf - ts)
            enqueue.append(te - ts)
            sampler.offer((frames, depth))
            n += 1
            if tf - t0 >= seconds:
                break
        self.samples, self.attempted = sampler.items, n
        return ({"request_p95_ms": 1000.0 * float(np.percentile(latencies, 95))},
                {"images": n * self.batch, "seconds": tf - t0, "latencies_s": latencies,
                 "enqueue_s": enqueue})

    def traced(self) -> dict:
        from h100bench.instrument import Launches
        from h100bench.trace import Profiled

        lead, n = self.cell.traffic["trace_lead"], self.cell.traffic["trace_requests"]
        for i in range(lead):
            self.pipe(self.requests[i % len(self.requests)]).cpu()
        prof, launches = Profiled(self.cell.device), Launches(self.model)
        with hooked(launches):
            prof.start()
            for i in range(n):
                self.pipe(self.requests[i % len(self.requests)]).cpu()
            prof.stop()
        sync(self.cell.device)
        return {"trace": prof.summary(), "launches": {"bound_s": dict(launches.bound_s)}}
