"""Gradio object-removal app (reference web-demos/hugging_face/app.py).
Counterpart of `propainter_tpu/demo/app.py`: the same widgets and the same
3-step flow (extract frames and pick a template frame; click to segment and
add masks; Track, then Inpaint), wired to the port's facade.

Requires `gradio`; without it `main` stops at its guard with a message
naming the gradio-free API, so the rest of the package never depends on
it. All mask and session state lives in gradio-free helpers
(demo/multimask.py, demo/session.py).

Run: python -m propainter_tpu_torch.demo.app --weights weights
[--device cuda|cpu] (the GPU by default; raises without one).
"""

from __future__ import annotations

import argparse

import numpy as np

from propainter_tpu_torch.demo.session import TwoStepSession


def build_app(facade):
    import gradio as gr

    state = {"frames": [], "points": [], "labels": [], "mask": None,
             "select_frame": 0, "fps": 24, "track_end": None}
    session = TwoStepSession(facade)
    multi = session.multi

    def extract_frames(video_path):
        from propainter_tpu_torch.utils.video import read_frames

        frames, fps, _, _ = read_frames(video_path)
        state["frames"] = [np.asarray(f) for f in frames]
        state["fps"] = fps or 24
        state["points"], state["labels"] = [], []
        state["select_frame"] = 0
        session.reset(state["frames"])
        n = len(state["frames"])
        return (state["frames"][0], f"{n} frames @ {fps} fps",
                gr.update(maximum=n - 1, value=0),
                gr.update(maximum=n, value=n))

    def select_template(frame_idx):
        """Scrub to the template frame (reference select_template,
        app.py:128-140); clicks reset, the segmenter re-embeds."""
        state["select_frame"] = int(frame_idx)
        state["points"], state["labels"] = [], []
        seg = getattr(facade, "segmenter", None)
        if seg is not None and hasattr(seg, "sam_controler"):
            seg.sam_controler.reset_image()
        return state["frames"][state["select_frame"]]

    def on_click(point_type, evt: "gr.SelectData"):
        x, y = evt.index
        state["points"].append([x, y])
        state["labels"].append(1 if point_type == "foreground" else 0)
        mask, _, painted = facade.first_frame_click(
            state["frames"][state["select_frame"]],
            np.array(state["points"]), np.array(state["labels"]))
        state["mask"] = mask
        return painted

    def clear_clicks():
        state["points"], state["labels"] = [], []
        return (state["frames"][state["select_frame"]]
                if state["frames"] else None)

    # -- multi-mask management (reference app.py:166-201) -------------------
    def add_mask(mask_dropdown):
        if state["mask"] is None:
            return gr.update(), gr.update(), \
                "Click the image to generate a mask first."
        name = multi.add_mask(state["mask"])
        selected = list(mask_dropdown) + [name]
        painted = multi.show(state["frames"][state["select_frame"]].copy(),
                             selected)
        state["points"], state["labels"] = [], []
        return (gr.update(choices=multi.mask_names, value=selected),
                painted, f"Added {name}.")

    def remove_masks():
        multi.remove_all()
        return (gr.update(choices=[], value=[]),
                state["frames"][state["select_frame"]]
                if state["frames"] else None,
                "Removed all masks.")

    def show_masks(mask_dropdown):
        if not state["frames"]:
            return None
        return multi.show(state["frames"][state["select_frame"]].copy(),
                          list(mask_dropdown))

    def _write_video(frames_list, name):
        import tempfile, os

        from propainter_tpu_torch.utils.video import write_video

        path = os.path.join(tempfile.mkdtemp(), name)
        write_video(list(frames_list), path, fps=state["fps"], quality=7)
        return path

    def track(mask_dropdown, track_end):
        # reference vos_tracking_video (app.py:203-262): render a painted
        # tracked-mask preview the user inspects BEFORE inpainting
        try:
            painted = session.track(
                list(mask_dropdown), state["select_frame"],
                int(track_end) if track_end else None,
                single_mask=state["mask"])
        except ValueError as e:
            return None, str(e)
        return (_write_video(painted, "track_out.mp4"),
                "Tracking finished — inspect the preview, then Inpaint.")

    def inpaint(mask_dropdown, ratio, dilate, raft_iter,
                subvideo, neighbor, ref_stride):
        # reference inpaint_video (app.py:264-296): consumes the stored
        # full-video masks, filtered to the selected ids
        try:
            out = session.inpaint(
                list(mask_dropdown), ratio=ratio,
                dilate_radius=int(dilate), raft_iter=int(raft_iter),
                subvideo_length=int(subvideo),
                neighbor_length=int(neighbor), ref_stride=int(ref_stride))
        except ValueError as e:
            return None, str(e)
        return _write_video(out, "inpaint_out.mp4"), "Inpainting finished!"

    with gr.Blocks() as app:
        gr.Markdown("## ProPainter — interactive object removal")
        with gr.Row():
            video_in = gr.Video(label="input video")
            first_frame = gr.Image(label="template frame (click the object)")
        status = gr.Textbox(label="status")
        frame_slider = gr.Slider(0, 1, 0, step=1, label="template frame")
        point_type = gr.Radio(["foreground", "background"],
                              value="foreground", label="click type")
        with gr.Row():
            clear_btn = gr.Button("Clear clicks")
            add_mask_btn = gr.Button("Add mask")
            remove_mask_btn = gr.Button("Remove mask")
        mask_dropdown = gr.Dropdown(multiselect=True, value=[], choices=[],
                                    label="masks for tracking/inpainting")
        track_end = gr.Slider(1, 1, 1, step=1, label="tracking end frame")
        with gr.Row():
            ratio = gr.Slider(0.1, 1.0, 1.0, label="resize ratio")
            dilate = gr.Slider(0, 16, 8, step=1, label="mask dilation")
            raft_iter = gr.Slider(1, 40, 20, step=1, label="RAFT iterations")
        with gr.Row():
            subvideo = gr.Slider(10, 200, 80, step=1, label="subvideo length")
            neighbor = gr.Slider(2, 40, 10, step=1, label="neighbor length")
            ref_stride = gr.Slider(2, 40, 10, step=1, label="ref stride")
        with gr.Row():
            track_btn = gr.Button("Track")
            inpaint_btn = gr.Button("Inpaint")
        with gr.Row():
            track_out = gr.Video(label="tracked preview")
            video_out = gr.Video(label="inpainted")

        # bundled example clip (the reference ships inputs/*.mp4 examples
        # in its gallery, app.py bottom; this repo's committed analogue is
        # the synthetic fixture clip)
        import os as _os

        _example = _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__)))), "assets", "demo_clip",
            "clip.mp4")
        if _os.path.exists(_example):
            gr.Examples(examples=[[_example]], inputs=[video_in],
                        label="example clip")

        video_in.upload(extract_frames, video_in,
                        [first_frame, status, frame_slider, track_end])
        frame_slider.release(select_template, frame_slider, first_frame)
        first_frame.select(on_click, point_type, first_frame)
        clear_btn.click(clear_clicks, None, first_frame)
        add_mask_btn.click(add_mask, mask_dropdown,
                           [mask_dropdown, first_frame, status])
        remove_mask_btn.click(remove_masks, None,
                              [mask_dropdown, first_frame, status])
        mask_dropdown.change(show_masks, mask_dropdown, first_frame)
        track_btn.click(track, [mask_dropdown, track_end],
                        [track_out, status])
        inpaint_btn.click(inpaint,
                          [mask_dropdown, ratio, dilate, raft_iter,
                           subvideo, neighbor, ref_stride],
                          [video_out, status])
    return app


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="weights")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit(
            "gradio is not installed in this environment. The demo's "
            "programmatic API is available without it:\n"
            "  from propainter_tpu_torch.demo import TrackingFacade, "
            "load_demo_models\n"
            "  models, sam_type = load_demo_models(weights_dir)\n"
            "  facade = TrackingFacade(models, sam_model_type=sam_type)\n"
            "  mask, _, _ = facade.first_frame_click(frame, points, labels)\n"
            "  masks, _, _ = facade.generator(frames, mask)\n"
            "  out = facade.inpaint(frames, masks)")

    from propainter_tpu_torch.demo.tracking import (
        TrackingFacade, load_demo_models)

    models, sam_type = load_demo_models(args.weights)
    facade = TrackingFacade(models, sam_model_type=sam_type,
                            device=args.device)
    build_app(facade).launch(server_port=args.port)


if __name__ == "__main__":
    main()
