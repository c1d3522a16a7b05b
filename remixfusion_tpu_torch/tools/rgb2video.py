"""Frame directory -> video (counterpart of remixfusion_tpu.tools.rgb2video,
reference tools/rgb2video.py):

    python -m remixfusion_tpu_torch.tools.rgb2video --frame_dir DIR \
        [--out out.mp4] [--fps 15] [--pattern '*.png']

PNG frames are read with the port's own decoder (utils/imageio.read_png).
The video is written with imageio's writer; where imageio is missing or
cannot write the format, an animated GIF is written with PIL beside the
requested path, as the JAX tool does. With neither library the tool raises
ImportError naming both.
"""

from __future__ import annotations

import argparse
import glob
import os

from remixfusion_tpu_torch.utils.imageio import read_png


def frames_to_video(frame_dir, out_path, fps=15, pattern="*.png"):
    """Write the frames of `frame_dir` matching `pattern`, in name order;
    returns the path written (out_path, or its .gif sibling)."""
    files = sorted(glob.glob(os.path.join(frame_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no frames matching {pattern} in {frame_dir}")
    frames = [read_png(f)[0] for f in files]
    try:
        import imageio
        with imageio.get_writer(out_path, fps=fps) as w:
            for frame in frames:
                w.append_data(frame)
        return out_path
    except (ImportError, ValueError, RuntimeError, OSError) as e:
        imageio_error = e
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"rgb2video needs imageio (with a writer for {out_path}) or "
            f"PIL (GIF); imageio: {imageio_error}; PIL: {e}") from e
    gif = os.path.splitext(out_path)[0] + ".gif"
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return gif


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--frame_dir", required=True)
    parser.add_argument("--out", default="out.mp4")
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument("--pattern", default="*.png")
    args = parser.parse_args()
    out = frames_to_video(args.frame_dir, args.out, args.fps, args.pattern)
    print("wrote", out)


if __name__ == "__main__":
    main()
