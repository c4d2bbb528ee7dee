from repro_torch.data.pipeline import (  # noqa: F401
    PipelineState,
    SyntheticTokenPipeline,
    make_pipeline,
)
