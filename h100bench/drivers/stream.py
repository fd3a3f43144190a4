"""Streamed serving: a closed, endless stream of uint8 frames through
``objcavit_torch.serving.stream_depth(pipeline, frames, batch_size)``, the
program's video path (a feeder thread stacks batches; one batch stays on
the card while the next is launched; each depth map is copied to the host).

Traffic keys: ``batch_size``; ``warmup_batches``, a stream of that many
batches at set-up; ``check_batches`` (``serving.py``); ``trace_lead`` and
``trace_batches``, the batches the traced window lets pass and then takes.
The stream visits the frames of the pool (``serving.POOL_FRAMES``) in a
seeded order, over and over. End to end: ``serve_img_per_s``, the depth maps on the
host over the window's wall time. ``attempted`` counts its images.
"""

from __future__ import annotations

import time

from h100bench.common import sync
from h100bench.drivers.serving import Reservoir, Server


class Driver(Server):
    def __init__(self, cell):
        from objcavit_torch.serving import stream_depth

        super().__init__(cell)
        self.order = cell.rng(1).permutation(len(self.pool))
        warm = cell.traffic["warmup_batches"]
        for i, _ in enumerate(stream_depth(self.pipe, self.frames(), self.batch)):
            if i + 1 == warm:
                break
        sync(cell.device)

    def frames(self):
        i = 0
        while True:
            yield self.pool[self.order[i % len(self.order)]]
            i += 1

    def window(self, seconds: float):
        from objcavit_torch.serving import stream_depth

        pipe, enqueue = self.pipe, []

        def call(frames):
            t = time.perf_counter()
            out = pipe(frames)
            enqueue.append(time.perf_counter() - t)
            return out

        sampler = Reservoir(self.cell.traffic["check_batches"], self.cell.rng(3))
        stream = stream_depth(call, self.frames(), self.batch)
        images = 0
        t0 = time.perf_counter()
        try:
            for frames, depth in stream:
                images += len(depth)
                sampler.offer((frames, depth))
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
        finally:
            stream.close()
        sync(self.cell.device)
        self.samples, self.attempted = sampler.items, images
        return ({"serve_img_per_s": images / (t1 - t0)},
                {"images": images, "seconds": t1 - t0, "enqueue_s": enqueue})

    def traced(self) -> dict:
        from h100bench.instrument import Launches, Stages
        from h100bench.trace import Profiled
        from objcavit_torch.serving import stream_depth

        lead, n = self.cell.traffic["trace_lead"], self.cell.traffic["trace_batches"]
        prof, launches, stages = (Profiled(self.cell.device), Launches(self.model),
                                  Stages(self.model))
        stream = stream_depth(self.pipe, self.frames(), self.batch)
        try:
            for i, _ in enumerate(stream):
                if i == lead:
                    launches.install()
                    stages.install()
                    prof.start()
                elif i == lead + n:
                    prof.stop()
                    break
        finally:
            stream.close()
            launches.remove()
            stages.remove()
        sync(self.cell.device)
        return {"trace": prof.summary(), "launches": {"bound_s": dict(launches.bound_s)},
                "stages": stages.ms_per_image()}
