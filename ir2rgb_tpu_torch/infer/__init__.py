from .stream import (
    StreamingGenerator,
    host_to_wire_u8,
    single_frame_infer,
    tensor2im,
)

__all__ = ["StreamingGenerator", "host_to_wire_u8", "single_frame_infer",
           "tensor2im"]
