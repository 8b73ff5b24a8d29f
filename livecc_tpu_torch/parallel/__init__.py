"""Multi-device training: the mesh's sharding rules, ZeRO-2 state
(``sharding.py``), the tensor- and sequence-parallel collectives
(``tp.py``), the pipeline-parallel step (``pipeline.py``:
``make_pp_train_step``, ``shard_params_pp``, ``pp_split``) and the memory
plans (``memory.py``: ``ServingPlan``, ``count_params``, ``serving_plan``)."""

_PIPELINE = ("make_pp_train_step", "shard_params_pp", "pp_split")
_MEMORY = ("ServingPlan", "count_params", "serving_plan")


def __getattr__(name):
    # imported on first use: pipeline.py and memory.py import the model,
    # which imports tp.py from this package
    if name in _PIPELINE:
        from livecc_tpu_torch.parallel import pipeline
        return getattr(pipeline, name)
    if name in _MEMORY:
        from livecc_tpu_torch.parallel import memory
        return getattr(memory, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
