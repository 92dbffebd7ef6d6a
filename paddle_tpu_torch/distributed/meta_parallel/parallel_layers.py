"""Pipeline layer segmentation — the port of
``paddle_tpu/distributed/meta_parallel/parallel_layers.py`` (:27-173).

``LayerDesc`` (a layer class and its arguments, built on demand),
``SharedLayerDesc`` (a weight-tied layer appearing in several places,
built once under its key) and ``PipelineLayer``, which builds the list
and cuts it into ``num_stages`` contiguous stages: ``"uniform"`` (equal
counts, the first ``n % stages`` one longer), ``"layer:<Class>"`` (at
occurrences of a class) or ``"param"`` (by parameter count). A shared
layer is one object, so its gradient sums over its uses.

As in the reference, every stage's layers live in this process: the
pipeline schedules (``distributed/pipeline.py``,
``distributed/pipeline_1f1b.py``) stack the stages' parameters on a
leading stage dim that ``ShardedTrainer`` cuts over the ``pp`` axis, so
each rank keeps its own stage. ``forward`` runs every stage in order on
one rank, the sequential fallback.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.layers.container import LayerList

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs
        if not issubclass(layer_cls, Layer):
            raise TypeError(f"{layer_cls} must be a Layer subclass")

    def build_layer(self) -> Layer:
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A weight-tied layer appearing in several stages (e.g. tied input
    and output embeddings), built once under ``key``."""

    def __init__(self, key: str, layer_cls, *args,
                 forward_func: Optional[Callable] = None,
                 shared_weight_attr: str = "weight", **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0, recompute_ctx=None):
        super().__init__()
        self._layer_descs = list(layers)
        self.loss_fn = loss_fn
        self.seg_method = seg_method
        self.recompute_interval = recompute_interval
        if topology is not None:
            self._num_stages = topology.get_dim("pipe")
        else:
            self._num_stages = num_stages or 1
        self._shared = {}
        built: List[Any] = []
        for desc in self._layer_descs:
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name not in self._shared:
                    self._shared[desc.layer_name] = desc.build_layer()
                built.append((desc, self._shared[desc.layer_name]))
            elif isinstance(desc, LayerDesc):
                built.append((desc, desc.build_layer()))
            elif isinstance(desc, Layer) or callable(desc):
                built.append((None, desc))
            else:
                raise TypeError(f"cannot interpret pipeline entry {desc!r}")
        self._built = built
        self.run_function = [b for _, b in built]
        # a repeated shared layer is one object: named_parameters lists
        # its parameters once, under its first index
        self.layers = LayerList([b for _, b in built if isinstance(b, Layer)])
        self.segment_parts = self._segment()

    # -- segmentation --------------------------------------------------------
    def _segment(self) -> List[int]:
        n = len(self._built)
        stages = self._num_stages
        if self.seg_method == "uniform" or not self.seg_method:
            return self._segment_uniform(n, stages)
        if self.seg_method.startswith("layer:"):
            cls_name = self.seg_method.split(":", 1)[1]
            marks = [i for i, (_, b) in enumerate(self._built)
                     if type(b).__name__ == cls_name]
            if len(marks) >= stages:
                per = len(marks) / stages
                bounds = [0]
                for s in range(1, stages):
                    bounds.append(marks[int(per * s)])
                bounds.append(n)
                return bounds
            return self._segment_uniform(n, stages)
        if self.seg_method == "param":
            weights = []
            for _, b in self._built:
                if isinstance(b, Layer):
                    weights.append(sum(p.numel() for p in b.parameters())
                                   or 1)
                else:
                    weights.append(1)
            target = sum(weights) / stages
            bounds = [0]
            acc = 0
            for i, w in enumerate(weights):
                acc += w
                if acc >= target * len(bounds) and len(bounds) < stages:
                    bounds.append(i + 1)
            while len(bounds) < stages:
                bounds.append(n)
            bounds.append(n)
            return bounds
        raise ValueError(f"unknown seg_method {self.seg_method}")

    @staticmethod
    def _segment_uniform(n: int, stages: int) -> List[int]:
        per, extra = n // stages, n % stages
        bounds = [0]
        for s in range(stages):
            bounds.append(bounds[-1] + per + (1 if s < extra else 0))
        return bounds

    def get_stage_layers(self, stage_id: int) -> List:
        lo, hi = self.segment_parts[stage_id], self.segment_parts[stage_id + 1]
        return [b for _, b in self._built[lo:hi]]

    def stage_fn(self, stage_id: int) -> Callable:
        """The stage as a callable over ``x``."""
        layers = self.get_stage_layers(stage_id)

        def run(x):
            for layer in layers:
                x = layer(x)
            return x

        return run

    @property
    def num_stages(self) -> int:
        return self._num_stages

    def shared_layers(self):
        return dict(self._shared)

    def forward(self, x):
        """Every stage in order on this rank (the sequential fallback)."""
        for _, layer in self._built:
            x = layer(x)
        return x
