"""Training: AdamW with f32 master weights, the train step with gradient
accumulation, the loop with auto-resume, and the int8 gradient codec."""
