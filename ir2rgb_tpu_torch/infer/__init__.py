from .stream import (
    StreamingGenerator,
    host_to_wire_u8,
    label2im,
    single_frame_infer,
    tensor2im,
    translate_clip,
)

__all__ = ["StreamingGenerator", "host_to_wire_u8", "label2im",
           "single_frame_infer", "tensor2im", "translate_clip"]
