"""Standalone PaliGemma and Gemma text generation on PyTorch (counterpart of
``blurr_tpu/models/paligemma``)."""
