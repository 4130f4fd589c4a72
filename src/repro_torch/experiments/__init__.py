"""RAGPerf's own experiments on the port: the paper's Figs. 5-12 and §5.8,
the serving studies (the QPS sweep, the stage pipeline, elastic scaling,
the generation engine, the scenario and chaos suites, the tracing-overhead
gate), the fused-retrieve gate and the sharded-retrieval sweep, one module
each, named as the JAX package's ``benchmarks/`` modules are.

Every module exposes ``run(scale=1.0, device="cuda") -> rows`` (rows of
``{"bench": ..., metric: value}``) and prints them as
``benchmark,metric,value`` CSV under ``__main__``; ``scale`` shrinks corpora
and request counts down to the reference's floors.
``python -m repro_torch.experiments.run`` runs them all.
"""
