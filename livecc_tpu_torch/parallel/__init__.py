"""Multi-device training: the mesh's sharding rules, ZeRO-2 state
(``sharding.py``), the tensor- and sequence-parallel collectives
(``tp.py``) and the pipeline-parallel step (``pipeline.py``:
``make_pp_train_step``, ``shard_params_pp``, ``pp_split``)."""

_PIPELINE = ("make_pp_train_step", "shard_params_pp", "pp_split")


def __getattr__(name):
    # imported on first use: pipeline.py imports the text tower, which
    # imports tp.py from this package
    if name in _PIPELINE:
        from livecc_tpu_torch.parallel import pipeline
        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
