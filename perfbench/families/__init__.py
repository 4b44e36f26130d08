"""The program's side of each configuration family, one module per
``family`` key of a configuration file: how the system under test is
built and stepped (``Program``), the leaves the benchmark draws its
weights as (``leaves``), the running statistics the reference keeps
(``buffers``), the classes the traffic draws labels from (``classes``)
and the model FLOPs of one chip's step (``flops_per_step``). Its plain
reference is ``perfbench/reference/<family>.py``.

A ``Program`` has ``model`` (the ``torch.nn.Module`` whose forward the
traced run hooks), ``optimizer`` (the object whose ``step`` the window's
call invokes once a step), ``step(x, y)`` (the window's call: one
optimizer step, returning the detached loss), ``batch(x, y)`` (the
program's form of one batch of the feed), ``named_parameters()``,
``named_buffers()`` and ``first_grads(initial)`` (each leaf's gradient as
the optimizer got it in the first step, worked out from its state).
"""
