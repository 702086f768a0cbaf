"""The paper's comparison optimizers (counterpart of ``repro.baselines``):
GaLore, LoRA and BAdam.  Their trainer cores are in
``repro_torch.trainers`` (``galore``, ``lora``, ``badam``, ``badam+q8``)."""
