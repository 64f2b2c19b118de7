"""Interactive apps: the web UI (gradio) and the reconstruction CLI driver.

Counterpart of `e4s2024_tpu/app.py` (SURVEY.md §2.9):

- `build_gradio_app` ~ gradio_swap.py:116-166: an image-swap tab, a
  video-swap tab with PTI sliders and a mask-editing tab. gradio is an
  optional dependency; without it the function raises.
- `recon_cli` ~ img_recon.py / test.py: reconstruction grids over a dataset
  and SSIM / PSNR / RMSE, written as PNGs and `metrics.txt` with no PIL.
- The mask-painting UI's operations (reference run_UI.py:35) are library
  calls over `pipelines.editor.Editor`: `editor_parse`,
  `editor_apply_stroke`, `editor_resynthesize`.

Images cross the API as (H, W, 3) arrays in [0, 255] and label maps as
(H, W) integer arrays, numpy, as in the JAX package.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from e4s2024_torch.ops.resize import resize_bilinear, resize_nearest

# 12-class label names (reference datasets/dataset.py:30)
SEG12_NAMES = ["background", "lip", "eyebrows", "eyes", "hair", "nose",
               "skin", "ears", "belowface", "mouth", "eye_glass", "ear_rings"]


def editor_parse(swapper, img255: np.ndarray) -> np.ndarray:
    """Whole-image parse -> (512, 512) int32 12-class label map, the mask
    the UI edits (reference run_UI.py loads it the same way)."""
    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(img255, np.float32), device=swapper.device)
        lbl = swapper._parse12(x.permute(2, 0, 1)[None] / 255.0)
    return lbl[0].cpu().numpy().astype(np.int32)


def editor_apply_stroke(label_map: np.ndarray, stroke_mask: np.ndarray,
                        class_idx: int) -> np.ndarray:
    """Assign every painted pixel to `class_idx`: one brush stroke of the
    reference's mask-painting UI (ui_run/mouse_event.py). A stroke of
    another size is resized nearest onto the label grid."""
    out = np.asarray(label_map).copy()
    stroke = np.asarray(stroke_mask)
    if stroke.shape[:2] != out.shape[:2]:
        stroke = resize_nearest(torch.as_tensor(stroke, dtype=torch.float32),
                                out.shape[:2]).numpy()
    out[stroke > 0.5] = int(class_idx)
    return out


def editor_resynthesize(swapper, img255: np.ndarray, edited_label: np.ndarray) -> np.ndarray:
    """Invert the image with its own parse, re-synthesise with the edited
    label map: the re-render of run_UI.py (reference run_UI.py:35,
    SURVEY.md §3.5). Returns (S, S, 3) uint8."""
    from e4s2024_torch.pipelines.editor import Editor

    ed = Editor(swapper.rgi)
    orig = editor_parse(swapper, img255)
    img_pm1 = np.asarray(img255, np.float32)[None] / 127.5 - 1.0
    sv = ed.invert(img_pm1, orig[None])
    out = ed.generate_from_label(sv, np.asarray(edited_label)[None],
                                 regional_mode=swapper.cfg.regional_mode)
    return torch.clamp((out[0] + 1.0) * 127.5, 0, 255).to(torch.uint8).cpu().numpy()


def _resize_u8(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) -> (size, size, 3) uint8, bilinear."""
    t = torch.as_tensor(np.asarray(img, np.float32)).permute(2, 0, 1)
    out = resize_bilinear(t, (size, size)).permute(1, 2, 0)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()


def build_gradio_app(swapper, video_pipeline=None, full_pipeline=None):
    """Gradio Blocks app: image swap, video swap with PTI controls, mask
    editing. `full_pipeline` (a FullFaceSwapPipeline) makes the image tab
    the zoo-enhanced swap, as in the reference gradio (gradio_swap.py:36);
    raw uploads are detected, aligned and pasted back either way. Raises
    RuntimeError where gradio is not installed."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; use the library APIs "
            "(FaceSwapper / FaceSwapVideoPipeline) or the CLI instead") from e

    def swap_image(source, target, aligned, all_faces=False):
        src, tgt = np.asarray(source), np.asarray(target)
        if all_faces:
            # the source identity onto every detected target face; it needs
            # detection on the raw frame, so it wins over the aligned flag
            if full_pipeline is not None:
                return full_pipeline.swap_raw_multi(src, tgt)
            return swapper.swap_all(src, tgt)
        if aligned:
            s = swapper.cfg.out_size
            src = _resize_u8(src, s) if src.shape[:2] != (s, s) else src
            tgt = _resize_u8(tgt, s) if tgt.shape[:2] != (s, s) else tgt
            if full_pipeline is not None:
                return full_pipeline.swap_batch(src[None], tgt[None])[0]
            out = swapper.swap_aligned(src[None], tgt[None])
            return out["image"][0].cpu().numpy()
        if full_pipeline is not None:
            return full_pipeline.swap_raw(src, tgt)
        return swapper.swap(src, tgt)

    def swap_video(source, video, pti_steps, pti_lr, recolor_lambda):
        from e4s2024_torch.video_io import extract_frames, write_video

        frames, fps = extract_frames(video)
        video_pipeline.cfg.pti.max_pti_steps = int(pti_steps)
        video_pipeline.cfg.pti.learning_rate = float(pti_lr)
        video_pipeline.cfg.pti.recolor_lambda = float(recolor_lambda)
        outs = video_pipeline(np.asarray(source), frames)
        out_path = os.path.join(tempfile.mkdtemp(), "swapped.mp4")
        return write_video(outs, out_path, fps, audio_from=video)

    with gr.Blocks(title="e4s2024 face swap") as app:
        with gr.Tab("Image swap"):
            with gr.Row():
                src = gr.Image(label="source")
                tgt = gr.Image(label="target")
            aligned = gr.Checkbox(value=False,
                                  label="inputs are pre-aligned crops (skip detection)")
            all_faces = gr.Checkbox(value=False,
                                    label="swap ALL detected faces in the target "
                                          "(multi-face; ignores the pre-aligned flag)")
            out = gr.Image(label="swapped")
            gr.Button("Swap").click(swap_image, [src, tgt, aligned, all_faces], out)
        if video_pipeline is not None:
            with gr.Tab("Video swap"):
                vsrc = gr.Image(label="source")
                vid = gr.Video(label="target video")
                steps = gr.Slider(0, 200, value=80, label="PTI steps")
                lr = gr.Number(value=1e-3, label="PTI lr")
                rl = gr.Number(value=5.0, label="recolor lambda")
                vout = gr.Video(label="result")
                gr.Button("Swap video").click(swap_video, [vsrc, vid, steps, lr, rl], vout)
        with gr.Tab("Mask editing"):
            # parse -> paint strokes per class -> re-synthesise (reference
            # run_UI.py, ui_run/)
            from e4s2024_torch.utils.image import colorize_label_map

            est = gr.State(value=None)   # the current label map
            eimg = gr.State(value=None)  # the current image
            with gr.Row():
                ein = gr.Image(label="image")
                emask = gr.Image(label="label map (12-class)")
            cls = gr.Dropdown(choices=[f"{i}: {n}" for i, n in enumerate(SEG12_NAMES)],
                              value="6: skin", label="brush class")
            brush = gr.ImageEditor(label="paint the stroke (white = brush)")
            eout = gr.Image(label="re-synthesized")

            def do_parse(img):
                lbl = editor_parse(swapper, np.asarray(img, np.float32))
                return lbl, np.asarray(img), colorize_label_map(lbl, 12)

            def do_stroke(lbl, sketch, cls_choice):
                if lbl is None or sketch is None:
                    return lbl, None
                layer = sketch["layers"][0] if isinstance(sketch, dict) else sketch
                stroke = np.asarray(layer)[..., :3].mean(-1) > 127
                lbl = editor_apply_stroke(lbl, stroke, int(str(cls_choice).split(":")[0]))
                return lbl, colorize_label_map(lbl, 12)

            def do_render(img, lbl):
                if img is None or lbl is None:
                    return None
                return editor_resynthesize(swapper, img, lbl)

            gr.Button("Parse").click(do_parse, [ein], [est, eimg, emask])
            gr.Button("Apply stroke").click(do_stroke, [est, brush, cls], [est, emask])
            gr.Button("Re-synthesize").click(do_render, [eimg, est], eout)
    return app


def recon_cli(swapper, dataset, out_dir: str, limit: int = 100) -> dict:
    """Reconstruction eval (reference img_recon.py / test.py): invert and
    re-synthesise each item of `dataset` (items (image (S, S, 3) in
    [-1, 1], label (M, M) ints), as `data.datasets.FaceMaskDataset` gives),
    write side-by-side grids `{i:05d}_recon.png` and `metrics.txt`, and
    return SSIM / PSNR / RMSE."""
    from e4s2024_torch.metrics import reconstruction_metrics
    from e4s2024_torch.utils.image import from_pm1, save_png, vis_faces_grid

    os.makedirs(out_dir, exist_ok=True)
    net, dev, dtype = swapper.rgi, swapper.device, swapper.dtype
    recons, gts = [], []
    for i in range(min(limit, len(dataset))):
        img, lbl = dataset[i]
        with torch.inference_mode():
            onehot = F.one_hot(torch.as_tensor(np.asarray(lbl), device=dev).long()[None],
                               swapper.cfg.num_seg_cls).permute(0, 3, 1, 2).to(dtype)
            x = torch.as_tensor(np.asarray(img, np.float32), device=dev).permute(2, 0, 1)[None]
            sv, _ = net.get_style_vectors(x.to(dtype), onehot)
            recon, _, _ = net.gen_img(None, net.cal_style_codes(sv), onehot,
                                      regional_mode=swapper.cfg.regional_mode)
        r = from_pm1(recon[0].float().permute(1, 2, 0).cpu().numpy())
        g = from_pm1(img)
        recons.append(r)
        gts.append(g)
        save_png(os.path.join(out_dir, f"{i:05d}_recon.png"), vis_faces_grid([[g, r]]))
    metrics = reconstruction_metrics(np.stack(recons), np.stack(gts), device=dev)
    with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
        f.write(str(metrics))
    return metrics
