"""LM serving on the card: the static (wave-batched) and continuous
(slotted-cache) engines, their request record, sampler and cache ops."""
