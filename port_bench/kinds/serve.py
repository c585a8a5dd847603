"""``serve``: one closed-loop client. Set-up builds the program's serving
engine from the weights (int8 calibrates on ``calib_images`` seeded
images), warms it up and serves ``warmup_requests`` requests. The window
sends a host uint8 batch of ``batch`` images from a seeded pool of
``pool_batches`` and waits for its answer on the host, again and again; a
reservoir drawn from the seed keeps ``checked_requests`` answers, of which
``checked_rows`` rows each are checked.

Parameters: ``batch``, ``precision``, ``quantize`` (null or "int8"),
``calib_images``, ``pool_batches``, ``warmup_requests``,
``checked_requests``, ``checked_rows``, ``check_chunk`` (optional, the
reference's rows at a time), ``trace_seconds``, ``limits``.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from port_bench import cells, inputs, reference
from port_bench.reference import int8
from port_bench.reference.lowp import fp8


class _Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _parts(out) -> tuple:
    """A served answer as a tuple of per-row arrays."""
    return out if isinstance(out, tuple) else (out,)


class Cell(cells.Base):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        n, pool = traffic["batch"], traffic["pool_batches"]
        imgs = inputs.images(inputs.host_rng(seed, inputs.STREAM_IMAGES), n * pool, self.h, self.w)
        self.pool = [np.ascontiguousarray(imgs[i * n:(i + 1) * n]) for i in range(pool)]
        self.calib = None
        if traffic.get("quantize"):
            self.calib = inputs.images(inputs.host_rng(seed, inputs.STREAM_CALIB),
                                       traffic["calib_images"], self.h, self.w)
        order = inputs.host_rng(seed, inputs.STREAM_ORDER)
        self.order = order.permutation(np.tile(np.arange(pool), 4)).tolist()
        self.sample_rng = inputs.host_rng(seed, inputs.STREAM_SAMPLE)
        self.kept = _Reservoir(traffic["checked_requests"], self.sample_rng)
        self.k = 0

    def start_program(self) -> None:
        from port_bench.program import serving_engine

        self.engine, self.serve = serving_engine(self.config, self.traffic, self.weights,
                                                 self.device, self.calib)
        self.engine.warmup()
        for _ in range(self.traffic["warmup_requests"]):
            self._request()

    def _request(self):
        j = self.order[self.k % len(self.order)]
        self.k += 1
        t0 = time.perf_counter()
        out = self.serve(self.pool[j])
        return j, out, time.perf_counter() - t0

    def run(self, seconds: float) -> cells.Record:
        lat, failed, count = [], 0, 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            j, out, dt = self._request()
            lat.append(dt * 1e3)
            count += 1
            self.kept.offer((j, out))
            failed += int(not all(np.isfinite(a).all() for a in _parts(out)))
            if time.perf_counter() >= end:
                break
        dt = time.perf_counter() - t0
        return cells.Record(seconds=dt, images=count * self.traffic["batch"], requests=count,
                            failed=failed, latencies_ms=lat)

    def stop_program(self) -> None:
        self.engine = self.serve = None
        cells.release(self.device)

    def samples(self) -> List[Tuple[int, int, object]]:
        """(pool batch, row, the request's answer) of each checked answer:
        ``checked_rows`` rows, drawn from the seed, of each request the
        reservoir kept."""
        rows = min(self.traffic["checked_rows"], self.traffic["batch"])
        return [(j, int(r), out) for j, out in self.kept.items
                for r in self.sample_rng.choice(self.traffic["batch"], rows, replace=False)]

    def pool_samples(self) -> List[Tuple[int, int, None]]:
        """As many (pool batch, row) pairs as a run checks, drawn from the
        seed over the pool (for the control, which serves nothing)."""
        rows = min(self.traffic["checked_rows"], self.traffic["batch"])
        return [(int(self.sample_rng.integers(len(self.pool))), int(r), None)
                for _ in range(self.traffic["checked_requests"])
                for r in self.sample_rng.choice(self.traffic["batch"], rows, replace=False)]

    @staticmethod
    def program_outputs(samples) -> List:
        return [out[r] if not isinstance(out, tuple) else tuple(o[r] for o in out)
                for _, r, out in samples]

    def _images(self, samples) -> torch.Tensor:
        return torch.from_numpy(np.stack([self.pool[j][r] for j, r, _ in samples])).to(self.device)

    def truth(self, samples) -> List:
        """The reference's answers (the family's: scores, or logits)."""
        qmax = 127 if self.traffic.get("quantize") == "int8" else None
        return self._reference(samples, qmax=qmax, lowp=None, as_program=False)

    def control(self, samples) -> List:
        """The reference one precision below the configuration's, in the
        program's place: int4 for int8, float8 for bfloat16."""
        if self.traffic.get("quantize") == "int8":
            return self._reference(samples, qmax=7, lowp=None, as_program=True)
        return self._reference(samples, qmax=None, lowp=fp8, as_program=True)

    @torch.no_grad()
    def _reference(self, samples, qmax, lowp, as_program: bool) -> List:
        images = self._images(samples)
        folded = self.model.fold(self.weights)
        decoder = self.model.decoders[0]  # the score path's, or the seg model's only
        chunk = self.traffic.get("check_chunk", 8)
        with reference.exact_float32():
            if qmax is not None:
                calib = torch.from_numpy(self.calib).to(self.device)
                chunks = [calib[i:i + 16] for i in range(0, len(calib) // 16 * 16, 16)]
                absmax = int8.calibrate(self.model, folded, chunks, (decoder,))
                q = int8.quantize(folded, absmax, qmax, (decoder,))
                head = [int8.forward(q, images[i:i + chunk], decoder)
                        for i in range(0, len(images), chunk)]
            else:
                head = [self.model.forward(folded, int8.nchw_input(images[i:i + chunk]),
                                           bn="folded", lowp=lowp or (lambda t: t),
                                           decoders=(decoder,))[0][0]
                        for i in range(0, len(images), chunk)]
            return self.family.reference_answers(torch.cat(head), images, as_program)

    def numbers(self, prog, truth):
        return self.family.serve_numbers(prog, truth)

    def check(self):
        samples = self.samples()
        return self.numbers(self.program_outputs(samples), self.truth(samples))
