"""Interactive terminal viewer — the GLRenderer loop without OpenGL.

A copy of ``spt_tpu.engine.display`` (stdlib and numpy), driving the
port's Renderer.  It replaces the reference's GLFW window + fullscreen-quad
display (GLRenderer.cpp:30-208) with ANSI truecolor half-block rendering
straight to the terminal: every character cell shows two pixels
(upper/lower).  Controls
mirror the reference (main.cpp:75-81): WASD moves, arrow keys look (stand-in
for mouse-drag), ESC/q quits.  Camera motion resets progressive accumulation
exactly like GLRenderer.cpp:145-161.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np


def _read_key(timeout: float = 0.0):
    """Non-blocking single-key read (with arrow-key escape sequences).

    Reads the raw fd with os.read: a buffered sys.stdin.read would swallow
    read-ahead bytes that select() can then never see (keys would appear to
    vanish)."""
    fd = sys.stdin.fileno()
    r, _, _ = select.select([fd], [], [], timeout)
    if not r:
        return None
    ch = os.read(fd, 1).decode("utf-8", "replace")
    if ch == "\x1b":
        r, _, _ = select.select([fd], [], [], 0.01)
        if not r:
            return "ESC"
        seq = os.read(fd, 2).decode("utf-8", "replace")
        return {"[A": "UP", "[B": "DOWN", "[C": "RIGHT", "[D": "LEFT"}.get(seq, None)
    return ch


def _to_ansi(img01: np.ndarray, cols: int, rows: int) -> str:
    """(H, W, 3) [0,1] -> ANSI half-block frame, nearest-resampled."""
    h, w, _ = img01.shape
    # two image rows per terminal row
    ys = (np.linspace(0, h - 1, rows * 2)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    small = (img01[ys][:, xs] * 255).astype(np.uint8)
    top = small[0::2]
    bot = small[1::2]
    lines = []
    for r in range(rows):
        row = []
        for c in range(cols):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c] if r < bot.shape[0] else (0, 0, 0)
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def run_viewer(renderer, max_fps: float = 30.0) -> None:
    """Drive the renderer interactively until ESC/q."""
    import termios
    import tty

    def _grid():
        """Terminal size -> display grid (ptys can report 0x0; clamp to a
        usable window either way)."""
        size = os.get_terminal_size()
        return (min(max(size.columns, 40), 160),
                min(max(size.lines - 2, 12), 50))

    try:
        cols, rows = _grid()
    except OSError:
        print("No TTY available; use headless mode instead.")
        return

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J\x1b[?25l")  # clear, hide cursor
    last_log = time.time()
    frames = 0
    try:
        while True:
            key = _read_key()
            if key in ("ESC", "q"):
                break
            dt = 1.0 / max_fps
            if key == "w":
                renderer.camera.process_keyboard(0, dt * 4)
            elif key == "s":
                renderer.camera.process_keyboard(1, dt * 4)
            elif key == "a":
                renderer.camera.process_keyboard(2, dt * 4)
            elif key == "d":
                renderer.camera.process_keyboard(3, dt * 4)
            elif key == "LEFT":
                renderer.camera.process_mouse(-30.0, 0.0)
            elif key == "RIGHT":
                renderer.camera.process_mouse(30.0, 0.0)
            elif key == "UP":
                renderer.camera.process_mouse(0.0, 15.0)
            elif key == "DOWN":
                renderer.camera.process_mouse(0.0, -15.0)
            elif key == "g":
                # integrator toggle: the reference's G backend switch
                # (GLRenderer.cpp:263-277) — resets accumulation
                name = renderer.toggle_integrator()
                sys.stdout.write(f"\x1b[2J\x1b[H\x1b[0mintegrator: {name}\n")
                sys.stdout.flush()

            renderer.render_frame()
            frames += 1
            # Follow terminal resizes (the reference's framebuffer-size
            # callback role, GLRenderer.cpp window resize ->
            # OptixBackend::resize): the DISPLAY grid re-reads the
            # terminal every frame and re-clears on change; the render
            # resolution itself stays put (Renderer.resize is the API for
            # that, and it restarts the accumulation).
            try:
                new_cols, new_rows = _grid()
            except OSError:
                new_cols, new_rows = cols, rows
            if (new_cols, new_rows) != (cols, rows):
                cols, rows = new_cols, new_rows
                sys.stdout.write("\x1b[2J")
            frame = _to_ansi(renderer.image(), cols, rows)
            sys.stdout.write("\x1b[H" + frame)
            now = time.time()
            if now - last_log > 5.0:  # GLRenderer.cpp:183-187
                fps = frames / (now - last_log)
                sys.stdout.write(
                    f"\n\x1b[0m{fps:5.1f} fps | "
                    f"{renderer.accumulated_samples:.0f} samples | WASD+arrows, q quits"
                )
                frames = 0
                last_log = now
            sys.stdout.flush()
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[?25h\x1b[0m\n")
