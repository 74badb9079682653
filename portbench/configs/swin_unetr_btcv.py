"""The program's Swin UNETR at the sizes of `swin_unetr_btcv.json`, built
through the port's own entry point. The loop's `do_ds` does not apply:
the model returns one output."""

from __future__ import annotations


def build(cfg: dict, device, remat: bool = False):
    from deformablelka_tpu_torch.models.swin_unetr import swin_unetr_btcv

    return swin_unetr_btcv(cfg["num_classes"], img_size=tuple(cfg["img_size"]),
                           feature_size=cfg["feature_size"], remat=remat, device=device)
