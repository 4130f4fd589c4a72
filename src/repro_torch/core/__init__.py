"""The port's RAG core: the pipeline stages behind the Fig. 4 interfaces,
assembled from a ``PipelineSpec`` through the port's own registry."""
