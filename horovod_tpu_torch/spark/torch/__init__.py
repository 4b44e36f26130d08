"""TorchEstimator: a Spark ML stage training a torch model on the port's
core (counterpart of ``horovod_tpu/spark/torch``; reference:
horovod/spark/torch/estimator.py:84-304).

The driver pickles the model (``torch.save``) and an optimizer factory;
each worker trains on its Store Parquet shard with the torch frontend's
``DistributedOptimizer`` and an initial parameter broadcast, and the fit
returns a :class:`TorchModel` transformer. The model, every batch and the
metrics live on the estimator's ``device``: the card unless the caller
passes ``device="cpu"`` (features and labels reach the model as float32,
as in the JAX package).
"""

import io
from typing import Callable, List, Optional

import numpy as np

from ...basics import resolve_device
from ..estimator import HorovodEstimator, HorovodModel, load_split_shard


def _serialize_torch(model) -> bytes:
    import torch
    buf = io.BytesIO()
    torch.save(model, buf)
    return buf.getvalue()


def _deserialize_torch(blob: bytes, device):
    """The pickled module, its tensors loaded straight onto ``device``
    (the module's classes, the flash kernel's wrapper among them, resolve
    by reference in this process)."""
    import torch
    return torch.load(io.BytesIO(blob), map_location=device,
                      weights_only=False)


class TorchEstimator(HorovodEstimator):
    """Usage (reference recipe)::

        est = TorchEstimator(model=net, optimizer=lambda p: SGD(p, lr=0.1),
                             loss=torch.nn.MSELoss(),
                             feature_cols=["features"], label_cols=["y"],
                             batch_size=16, epochs=4)
        torch_model = est.fit(df)
        pred_df = torch_model.transform(df)

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (the
    reference passes a constructed optimizer and rebuilds it remotely; a
    factory expresses the same contract without private state surgery).
    ``device``: where the model trains and predicts; the card unless
    ``"cpu"`` is passed (without a card and without ``device="cpu"``
    construction raises).
    """

    _param_names: List[str] = HorovodEstimator._param_names + ["device"]

    def __init__(self, **kwargs):
        self.device = None
        super().__init__(**kwargs)
        self.device = resolve_device(self.device)

    def _pre_fit_validate(self) -> None:
        super()._pre_fit_validate()
        resolve_device(self.device)   # a missing card raises before any IO
        spec = self._validation_spec()
        if self.streaming and spec and spec[0] == "fraction" \
                and spec[1] > 0:
            # a fraction split needs the shard length up front, which
            # streaming exists to avoid; the column form filters per
            # batch. Raised HERE so the user does not pay a full Parquet
            # materialization for a config error.
            raise ValueError(
                "streaming=True supports the validation COLUMN form "
                "(rows with column value > 0), not a fraction — the "
                "fraction split would require materializing the shard")

    def _make_train_fn(self):
        blob = _serialize_torch(self.model)
        opt_factory = self.optimizer
        loss_obj = self.loss
        feature_cols = list(self.feature_cols)
        label_cols = list(self.label_cols)
        batch_size, epochs = int(self.batch_size), int(self.epochs)
        shuffle, seed = bool(self.shuffle), int(self.random_seed)
        validation_spec = self._validation_spec()
        sample_weight_col = self.sample_weight_col
        fs = getattr(self._resolve_store(), "fs", None)
        streaming = bool(self.streaming)
        device = resolve_device(self.device)
        # metrics: fn(outputs, targets) -> scalar, evaluated per epoch on
        # the held-out set (reference: TorchEstimator metrics,
        # spark/torch/estimator.py evaluation on the val DataLoader).
        # Accepts {name: fn} or [fn, ...] (named by fn.__name__, the
        # list convention the Keras sibling uses).
        if isinstance(self.metrics, dict):
            metric_fns = dict(self.metrics)
        elif self.metrics:
            metric_fns = {}
            for i, f in enumerate(self.metrics):
                name = getattr(f, "__name__", None) or f"metric_{i}"
                if name in metric_fns or name == "<lambda>":
                    # disambiguate duplicates/lambdas instead of silently
                    # keeping only the last same-named metric
                    name = f"{name.strip('<>')}_{i}"
                metric_fns[name] = f
        else:
            metric_fns = {}

        def train_fn(rank: int, size: int, train_path: str):
            import torch

            from ... import torch as hvd_t

            model = _deserialize_torch(blob, device)
            loss_fn = loss_obj if loss_obj is not None else torch.nn.MSELoss()
            opt = (opt_factory(model.parameters()) if callable(opt_factory)
                   and not hasattr(opt_factory, "param_groups")
                   else opt_factory)
            if opt is None:
                opt = torch.optim.SGD(model.parameters(), lr=0.01)
            if size > 1:
                hvd_t.broadcast_parameters(model.state_dict(), root_rank=0)
                opt = hvd_t.DistributedOptimizer(
                    opt, named_parameters=model.named_parameters())

            def batch_loss(pred, target, weights):
                """Per-row weighting (reference `sample_weight_col`):
                computed through the loss's reduction='none' form, then
                weight-averaged so an all-ones column matches the
                unweighted loss exactly."""
                if weights is None:
                    return loss_fn(pred, target)
                if not hasattr(loss_fn, "reduction"):
                    raise ValueError(
                        "sample_weight_col requires a loss module with a "
                        "`reduction` attribute (torch.nn losses); got "
                        f"{type(loss_fn).__name__}")
                prev = loss_fn.reduction
                loss_fn.reduction = "none"
                try:
                    per = loss_fn(pred, target)
                finally:
                    loss_fn.reduction = prev
                per = per.reshape(len(per), -1).mean(dim=1)
                return (per * weights).sum() / weights.sum().clamp_min(
                    torch.finfo(weights.dtype).tiny)

            history = []
            val_history = []
            metrics_history = {name: [] for name in metric_fns}

            def eval_val(xv, yv):
                # eval mode: dropout off, batchnorm uses (and does not
                # update) running stats — the held-out set must not leak
                # into the shipped model. Snapshot the PRIOR mode PER
                # SUBMODULE: a user may have frozen individual layers via
                # .eval() before handing the model over, and root-level
                # train() would unfreeze them.
                modes = [(m, m.training) for m in model.modules()]
                model.eval()
                with torch.no_grad():
                    out_v = model(xv)
                    val_history.append(float(loss_fn(out_v, yv)))
                    for name, fn in metric_fns.items():
                        metrics_history[name].append(float(fn(out_v, yv)))
                for m, was_training in modes:
                    m.training = was_training

            def finish():
                # host copies: the result may be pickled back from an
                # executor, and a bf16 tensor has no numpy form
                state = {k: v.detach().cpu() if hasattr(v, "cpu") else v
                         for k, v in model.state_dict().items()}
                return {"state_dict": state, "loss_history": history,
                        "val_loss_history": val_history,
                        "metrics_history": metrics_history}

            if streaming:
                # Petastorm-reader mode: row groups stream through
                # ParquetBatchIterator; memory holds one row group + one
                # batch (+ the usually-small validation subset when the
                # validation column selects one).
                #
                # Multi-process lockstep: row-group sharding gives ranks
                # UNEQUAL batch counts (unlike the in-memory rank::size
                # row split), and every opt.step() is a collective — so
                # each step first agrees via a Max-allreduce whether ANY
                # rank still has data, and a starved rank participates
                # with an explicit zero-gradient step (forward on a zero
                # batch scaled by 0.0, so the bucket hooks fire and
                # submit zeros — the Join convention, reference
                # tensor_queue.cc zero substitution).
                from ... import collectives as _coll
                from ..store import ParquetBatchIterator

                val_col = (validation_spec[1]
                           if validation_spec
                           and validation_spec[0] == "column" else None)
                extra = ([sample_weight_col] if sample_weight_col else []) \
                    + ([val_col] if val_col else [])
                it = ParquetBatchIterator(
                    train_path, feature_cols + label_cols + extra,
                    batch_size, rank, size, fs=fs, shuffle=shuffle,
                    seed=seed)
                zero_x = None

                def get_zero_x():
                    # template input for zero-grad participation; a rank
                    # can be starved an entire epoch (fewer row groups
                    # than ranks), so fall back to one template row read
                    # from the dataset itself
                    nonlocal zero_x
                    if zero_x is None:
                        t = next(iter(ParquetBatchIterator(
                            train_path, feature_cols, 1, 0, 1, fs=fs)))
                        width = _stack(
                            [t[c] for c in feature_cols]).shape[1]
                        zero_x = torch.zeros((1, width),
                                             dtype=torch.float32,
                                             device=device)
                    return zero_x

                for epoch in range(epochs):
                    it.set_epoch(epoch)
                    epoch_loss, n_rows = 0.0, 0
                    val_parts = []
                    batches = iter(it)
                    while True:
                        batch = next(batches, None)
                        while batch is not None and val_col is not None:
                            vmask = np.asarray(batch[val_col]) > 0
                            if vmask.any():
                                val_parts.append(
                                    {c: np.asarray(batch[c])[vmask]
                                     for c in feature_cols + label_cols})
                            keep = ~vmask
                            if keep.any():
                                batch = {c: np.asarray(v)[keep]
                                         for c, v in batch.items()}
                                break
                            batch = next(batches, None)  # all-val batch
                        have = batch is not None
                        if size > 1:
                            flag = _coll.allreduce(
                                np.array([1.0 if have else 0.0],
                                         np.float32),
                                op=_coll.ReduceOp.MAX,
                                name="spark_stream.have")
                            if float(np.asarray(flag)[0]) <= 0:
                                break
                        elif not have:
                            break
                        if have:
                            xb = _stack([batch[c] for c in feature_cols])
                            yb = _stack([batch[c] for c in label_cols])
                            xt = _on(xb)
                            if zero_x is None:
                                zero_x = torch.zeros(
                                    (1, xt.shape[1]), dtype=torch.float32,
                                    device=device)
                            yt = _on(yb)
                            if yt.ndim == 1:
                                yt = yt[:, None]
                            wb = None
                            if sample_weight_col:
                                wb = _on(batch[sample_weight_col])
                            opt.zero_grad()
                            loss = batch_loss(model(xt), yt, wb)
                            loss.backward()
                            opt.step()
                            epoch_loss += float(loss.detach()) * len(xt)
                            n_rows += len(xt)
                        else:
                            # zero-grad participation runs the forward in
                            # eval mode: BatchNorm in train mode rejects
                            # a 1-row batch and would smear zeros into
                            # running stats on this rank only (buffers
                            # are not allreduced); grads are zero either
                            # way because of the * 0.0
                            modes = [(m, m.training)
                                     for m in model.modules()]
                            model.eval()
                            try:
                                opt.zero_grad()
                                (model(get_zero_x()).sum() * 0.0).backward()
                            finally:
                                for m, was in modes:
                                    m.training = was
                            opt.step()
                    history.append(epoch_loss / max(n_rows, 1))
                    if val_parts:
                        xv = _on(_stack([
                            np.concatenate([p[c] for p in val_parts])
                            for c in feature_cols]))
                        yv = _on(_stack([
                            np.concatenate([p[c] for p in val_parts])
                            for c in label_cols]))
                        if yv.ndim == 1:
                            yv = yv[:, None]
                        eval_val(xv, yv)
                return finish()

            train, val, w_t, w_v = load_split_shard(
                train_path, feature_cols, label_cols, rank, size,
                sample_weight_col=sample_weight_col,
                validation_spec=validation_spec, fs=fs)
            xt = _on(_stack(train[:len(feature_cols)]))
            yt = _on(_stack(train[len(feature_cols):]))
            if yt.ndim == 1:
                yt = yt[:, None]
            wt = _on(w_t) if w_t is not None else None
            n_val = 0
            if val is not None:
                xv = _on(_stack(val[:len(feature_cols)]))
                yv = _on(_stack(val[len(feature_cols):]))
                if yv.ndim == 1:
                    yv = yv[:, None]
                n_val = len(xv)

            g = torch.Generator().manual_seed(seed)
            n = len(xt)
            for _ in range(epochs):
                # the permutation is drawn on the host generator, as in
                # the JAX package, and indexes the device tensors
                order = (torch.randperm(n, generator=g) if shuffle
                         else torch.arange(n)).to(device)
                epoch_loss = 0.0
                for s in range(0, n, batch_size):
                    idx = order[s:s + batch_size]
                    opt.zero_grad()
                    loss = batch_loss(model(xt[idx]), yt[idx],
                                      wt[idx] if wt is not None else None)
                    loss.backward()
                    opt.step()
                    epoch_loss += float(loss.detach()) * len(idx)
                history.append(epoch_loss / max(n, 1))
                if n_val:
                    eval_val(xv, yv)
            return finish()

        def _on(a):
            """A copy of a host array as a float32 tensor on the device
            (the array may be a read-only view of a Parquet column)."""
            import torch
            return torch.tensor(np.asarray(a, np.float32), device=device)

        def _stack(arrays):
            out = [np.asarray(a) for a in arrays]
            out = [a.reshape(len(a), -1) if a.ndim > 1 else a[:, None]
                   for a in out]
            if len(out) == 1:
                return out[0]
            return np.concatenate(out, axis=1)

        return train_fn

    def _make_model(self, train_result):
        import torch
        device = resolve_device(self.device)
        model = _deserialize_torch(_serialize_torch(self.model), device)
        state = {k: torch.as_tensor(v)
                 for k, v in train_result["state_dict"].items()}
        model.load_state_dict(state)
        return TorchModel(model, self.feature_cols, self.label_cols,
                          self.output_cols, device=device,
                          loss_history=train_result.get("loss_history"),
                          val_loss_history=train_result.get(
                              "val_loss_history"),
                          metrics_history=train_result.get(
                              "metrics_history"))


class TorchModel(HorovodModel):
    """Transformer carrying the trained torch module (reference:
    spark/torch/estimator.py TorchModel); it predicts on ``device``, the
    card unless ``"cpu"`` is passed."""

    def __init__(self, model, feature_cols: List[str],
                 label_cols: List[str],
                 output_cols: Optional[List[str]] = None,
                 loss_history=None, val_loss_history=None,
                 metrics_history=None, device=None):
        super().__init__(feature_cols, label_cols, output_cols)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_history = loss_history or []
        self.val_loss_history = val_loss_history or []
        self.metrics_history = metrics_history or {}

    def getModel(self):
        return self.model

    def _predict(self, features: np.ndarray) -> np.ndarray:
        import torch
        self.model.eval()
        with torch.no_grad():
            out = self.model(torch.from_numpy(
                np.asarray(features, np.float32)).to(self.device))
        return out.cpu().numpy()
