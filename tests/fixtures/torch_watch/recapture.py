"""A program built anew on every call, for the port's compilewatch.

``Doubler.rebuild_each_call`` wraps its work in a new ``StaticGraph`` on
every call, so on the card every call captures a CUDA graph (the defect:
inside ``compilewatch.steady()`` each capture is a violation at the
``StaticGraph(`` line below). ``Doubler.reuse`` builds its program once
and replays it after the first call (the clean twin). On the CPU neither
captures: a StaticGraph there runs its function.
"""
import torch

from deeplearning4j_tpu_torch.models._cuda_graph import StaticGraph


class Doubler:
    def __init__(self, device, n=1024):
        self.device = device
        self.x = torch.arange(n, dtype=torch.float32, device=device)
        self.y = torch.empty_like(self.x)
        self.program = None

    def _run(self):
        torch.mul(self.x, 2.0, out=self.y)

    def rebuild_each_call(self):
        StaticGraph(self._run, self.device)()    # a new program every call
        return self.y

    def reuse(self):
        if self.program is None:
            self.program = StaticGraph(self._run, self.device)
        self.program()
        return self.y
