"""PIL-based PaliGemma processor for the text demo.

Counterpart of ``blurr_tpu/models/paligemma/processing.py`` (the
reference's ``src/model/paligemma/processing.py``): a PIL bicubic resize,
rescale and normalize in numpy, and the PaliGemma prompt
(``<image>`` * N + BOS + text + "\\n") through the port's own
``add_image_tokens_to_prompt`` and ``setup_paligemma_tokenizer``. PIL is
imported inside the functions that use it: nothing else of the port needs
it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from blurr_tpu_torch.models.pi0.processing import (
    add_image_tokens_to_prompt,
    setup_paligemma_tokenizer,
)

IMAGENET_STANDARD_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
IMAGENET_STANDARD_STD = np.array([0.5, 0.5, 0.5], np.float32)


def process_images(images: List, size) -> List[np.ndarray]:
    """PIL images -> float32 [C, H, W] arrays: a bicubic resize to ``size``
    (height, width), scaled by 1/255, normalized by the ImageNet-standard
    mean and std."""
    from PIL import Image

    out = []
    for image in images:
        image = image.resize((size[1], size[0]), resample=Image.Resampling.BICUBIC)
        arr = (np.array(image) * (1 / 255.0)).astype(np.float32)
        arr = (arr - IMAGENET_STANDARD_MEAN) / IMAGENET_STANDARD_STD
        out.append(arr.transpose(2, 0, 1))
    return out


class PaliGemmaProcessor:
    IMAGE_TOKEN = "<image>"

    def __init__(self, tokenizer, num_image_tokens: int, image_size: int):
        self.image_seq_length = num_image_tokens
        self.image_size = image_size
        self.image_token_id = setup_paligemma_tokenizer(tokenizer, self.IMAGE_TOKEN)
        self.tokenizer = tokenizer

    def __call__(self, text: List[str], images: List, padding: str = "longest",
                 truncation: bool = True) -> dict:
        """One prompt and one PIL image -> numpy ``pixel_values`` [1, 3, H, W]
        float32, ``input_ids`` and ``attention_mask`` [1, S] int32."""
        if not len(images) == len(text) == 1:
            raise ValueError(f"the text demo takes one prompt and one image, got "
                             f"{len(text)} and {len(images)}")
        pixel_values = np.stack(
            process_images(images, (self.image_size, self.image_size)), axis=0
        )
        input_strings = [
            add_image_tokens_to_prompt(
                prefix_prompt=prompt,
                bos_token=self.tokenizer.bos_token,
                image_seq_len=self.image_seq_length,
                image_token=self.IMAGE_TOKEN,
            )
            for prompt in text
        ]
        inputs = self.tokenizer(
            input_strings, return_tensors="np", padding=padding, truncation=truncation
        )
        return {
            "pixel_values": pixel_values,
            "input_ids": np.asarray(inputs["input_ids"], np.int32),
            "attention_mask": np.asarray(inputs["attention_mask"], np.int32),
        }
