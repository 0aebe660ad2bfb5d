"""The batched solve: lane math (plain torch), the dense layout, the
CUDA kernel wrappers, the tick engine and the device-resident solver."""
