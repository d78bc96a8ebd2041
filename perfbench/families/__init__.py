"""Model families: everything of the benchmark that depends on the model.

A configuration file names its family (``"family": "kfnet"``), and
``run.py`` loads ``families/<family>.py``. A family brings that module,
its plain reference (``reference/<family>_ref.py``: float32 PyTorch with
TF32 off, importing nothing of the program), its configuration files, a
limits file per cell and the readers of metrics only it has. It edits no
shared file: ``run.py``, ``loops.py``, ``check.py``, ``tracing.py``,
``flops.py`` and ``traffic/`` take every family's end-to-end numbers the
same way.

A family module provides:

``program_config(cfg)``
    the program's configuration objects made from the file (opaque to the
    harness, handed back to the functions below as ``prog``)
``modules()``
    {key: module} of the program that the runners and the spans reach
``build_kernels(device)``
    builds (or loads from the checkout's build directory) what the program
    would otherwise build inside the window
``make_weights(cfg, seed, device)``, ``count(cfg)``
    the weights from a seed, made on the device, and their number
``Server(prog, params, cfg, mix, pool, seed, device)``
    for the serving modes ("stream", "fleet"): an object whose
    ``tick(row, reset)`` serves pool row ``row`` (``reset``: (B,) bool, the
    slots whose track restarts) and returns (poses (B, 4, 4), inliers
    (B,)) on the host, and whose ``keep()`` returns, on the device, what
    the check needs of the tick just served (a tuple of (B, ...) tensors)
``sequences(prog, params, mix, device)``
    for the "offline" mode: ``run(frames)``, an iterator over the chunks of
    one recorded sequence of host frames, each a tuple of (frames, ...)
    tensors on the device
``NUMBERS``, ``compare(cfg, mix, params, pool, rec, seed, device)``,
``failures(cfg, mix, rec, seed, device)``
    the check: the names of the numbers it can compare, in order; the
    numbers of a run's record; (answers that are no pose, of them those
    that failed)
``control(cfg, mix, params, pool, seed, device, ticks, frames)``
    the record the reference makes in the program's place one precision
    lower (``control.py``)

and for a traced run (``--trace 1``): ``PATCHES`` ((module key, attribute
path, span, CUDA events) of the harness's spans), ``layer_patches(spans,
mods)`` ((owner, attribute, value) of further spans), ``LAYERS`` (the
spans that name a kernel's layer), ``REPLAY_SPAN`` (the span of a graph
replay whose kernels take the layer of their place in the eager step, or
None), ``attribution_step(prog, params, frame_shape, device)`` (a call
that runs that eager step), and the analytic work (``frame_flops``) and
kernel bounds its own metric readers use.
"""
