"""Graphical (tkinter) front-end — form parity with the reference desktop GUI.

The port's counterpart of vr_video_generator_tpu/ui/tkapp.py: the same form
over ``ui.app``'s fields, whose Run and Repair start the port's CLI and
checktool (on the card by default).

The reference ships a dearpygui window (reference UserInterface.py:185-338):
labeled path inputs with file-dialog buttons, an encoder combo with model
descriptions (:232), numeric parameter fields (:242-250), a repair-mode combo
(:253), a live read-only CLI-command preview (:268-270), green Run / red Stop
buttons spawning/killing the pipeline subprocess (:274-276, :106-140), and
Debug-folder browsing (:263,279). The same form is built on the stdlib
tkinter; all state/preview/run-stop logic lives
in the display-independent ``FormModel`` (tested headlessly — the tk layer
is a thin widget binding).

Run with: python -m vr_video_generator_tpu_torch.ui.tkapp
Falls back with a clear message when no display is available (use
``python -m vr_video_generator_tpu_torch.ui.app`` for the console form).
"""

from __future__ import annotations

import os
import shlex
from typing import Callable, Dict, Optional

from vr_video_generator_tpu_torch.ui.app import (DEFAULT_FIELDS,
                                                 PipelineProcess,
                                                 _with_auto_output,
                                                 auto_output_name,
                                                 build_command,
                                                 integrity_report,
                                                 repair_command)

# Combo labels mirror the reference's descriptive items
# (reference UserInterface.py:232-233, :253-255).
ENCODER_ITEMS: Dict[str, str] = {
    "vits: Small model, faster": "vits",
    "vitb: Base model, more consistent": "vitb",
    "vitl: Large model, best quality": "vitl",
    "vitg: Giant model (no official checkpoint)": "vitg",
}
REPAIR_ITEMS: Dict[str, str] = {
    "0 - Full, Default": "0",
    "1 - Rerun start_frame..end_frame, don't combine": "1",
    "2 - Combine and export full video with audio": "2",
    "3 - [Debug] Combine video only": "3",
}
PATH_FIELDS = ("VideoDir", "OutputDir", "DebugDir", "SubClipDir",
               "encoder_path")
INT_FIELDS = ("offset_step_size", "Num_Workers", "num_gpu", "Num_GPU_Workers",
              "Max_Frame_Count", "start_frame", "end_frame", "batch_size",
              "depth_stride", "stride_audit_every")
FLOAT_FIELDS = ("offset_fg", "offset_bg")


class FormModel:
    """Display-independent state of the GUI form: field values, combo
    label<->value mapping, command preview, run/stop, debug listing."""

    def __init__(self) -> None:
        self.fields: Dict[str, str] = dict(DEFAULT_FIELDS)
        self.proc = PipelineProcess()

    def set_field(self, key: str, value: str) -> None:
        if key not in self.fields:
            raise KeyError(key)
        self.fields[key] = value

    def set_encoder_item(self, label: str) -> None:
        self.fields["encoder"] = ENCODER_ITEMS[label]

    def set_repair_item(self, label: str) -> None:
        self.fields["repair_mode"] = REPAIR_ITEMS[label]

    def encoder_label(self) -> str:
        for label, value in ENCODER_ITEMS.items():
            if value == self.fields["encoder"]:
                return label
        return next(iter(ENCODER_ITEMS))

    def repair_label(self) -> str:
        for label, value in REPAIR_ITEMS.items():
            if value == self.fields["repair_mode"]:
                return label
        return next(iter(REPAIR_ITEMS))

    def auto_output(self) -> str:
        """Fill OutputDir from VideoDir (reference auto_update_filename)."""
        name = auto_output_name(self.fields["VideoDir"])
        self.fields["OutputDir"] = name
        return name

    def preview(self) -> str:
        return shlex.join(build_command(_with_auto_output(self.fields)))

    def validate(self) -> Optional[str]:
        """None when runnable, else a human-readable problem description."""
        for key in INT_FIELDS:
            try:
                int(self.fields[key])
            except ValueError:
                return f"{key} must be an integer (got {self.fields[key]!r})"
        for key in FLOAT_FIELDS:
            try:
                float(self.fields[key])
            except ValueError:
                return f"{key} must be a number (got {self.fields[key]!r})"
        if not self.fields["VideoDir"]:
            return "VideoDir is required"
        return None

    def run(self) -> None:
        problem = self.validate()
        if problem:
            raise ValueError(problem)
        self.proc.start(build_command(_with_auto_output(self.fields)))

    def repair_command(self) -> list:
        """argv for the check-and-repair tool (ui.app.repair_command; the
        reference GUI has no working equivalent)."""
        return repair_command(self.fields)

    def repair(self) -> None:
        """Remove broken subclips and regenerate their exact ranges, as a
        managed subprocess (same Stop button as Run)."""
        problem = self.validate()
        if problem:
            raise ValueError(problem)
        self.proc.start(self.repair_command())

    def stop(self) -> None:
        self.proc.stop()

    def running(self) -> bool:
        return self.proc.running()

    def debug_listing(self) -> list:
        dbg = self.fields["DebugDir"]
        if not os.path.isdir(dbg):
            return []
        return sorted(os.listdir(dbg))

    def verify_report(self) -> str:
        """Subclip integrity report — implements the reference's dormant
        "Verify Integrity" button (reference UserInterface.py:276,
        callback=None)."""
        return integrity_report(self.fields["SubClipDir"],
                                self.fields["VideoDir"],
                                debug_dir=self.fields["DebugDir"])


def run_app() -> int:  # pragma: no cover - needs a display
    try:
        import tkinter as tk
        from tkinter import filedialog, messagebox, ttk
    except ImportError:
        print("tkinter is not available; use the console UI: "
              "python -m vr_video_generator_tpu_torch.ui.app")
        return 1
    try:
        root = tk.Tk()
    except tk.TclError as exc:
        print(f"no display available ({exc}); use the console UI: "
              "python -m vr_video_generator_tpu_torch.ui.app")
        return 1

    model = FormModel()
    root.title("VR SBS Video Generator (CUDA)")
    vars_: Dict[str, tk.StringVar] = {}
    preview_var = tk.StringVar()

    def refresh_preview(*_args) -> None:
        for key, var in vars_.items():
            model.fields[key] = var.get()
        preview_var.set(model.preview())

    body = ttk.Frame(root, padding=8)
    body.grid(sticky="nsew")
    root.columnconfigure(0, weight=1)
    row = 0

    def add_entry(key: str, browse: Optional[Callable] = None) -> None:
        nonlocal row
        ttk.Label(body, text=key).grid(row=row, column=0, sticky="w")
        var = tk.StringVar(value=model.fields[key])
        var.trace_add("write", refresh_preview)
        vars_[key] = var
        ttk.Entry(body, textvariable=var, width=60).grid(
            row=row, column=1, sticky="ew")
        if browse is not None:
            ttk.Button(body, text="Browse", command=browse).grid(
                row=row, column=2)
        row += 1

    def browse_file(key: str) -> Callable:
        def cb() -> None:
            chosen = filedialog.askopenfilename()
            if chosen:
                vars_[key].set(chosen)
                if key == "VideoDir" and not vars_["OutputDir"].get():
                    vars_["OutputDir"].set(auto_output_name(chosen))
        return cb

    def browse_dir(key: str) -> Callable:
        def cb() -> None:
            chosen = filedialog.askdirectory()
            if chosen:
                vars_[key].set(chosen)
        return cb

    add_entry("VideoDir", browse_file("VideoDir"))
    add_entry("OutputDir", browse_dir("OutputDir"))
    add_entry("DebugDir", browse_dir("DebugDir"))
    add_entry("SubClipDir", browse_dir("SubClipDir"))
    add_entry("encoder_path", browse_file("encoder_path"))

    ttk.Label(body, text="encoder").grid(row=row, column=0, sticky="w")
    enc_var = tk.StringVar(value=model.encoder_label())
    enc_box = ttk.Combobox(body, textvariable=enc_var,
                           values=list(ENCODER_ITEMS), state="readonly")
    enc_box.grid(row=row, column=1, sticky="ew")
    row += 1

    ttk.Label(body, text="repair_mode").grid(row=row, column=0, sticky="w")
    rep_var = tk.StringVar(value=model.repair_label())
    rep_box = ttk.Combobox(body, textvariable=rep_var,
                           values=list(REPAIR_ITEMS), state="readonly")
    rep_box.grid(row=row, column=1, sticky="ew")
    row += 1

    def combo_changed(*_args) -> None:
        model.set_encoder_item(enc_var.get())
        model.set_repair_item(rep_var.get())
        vars_["encoder"].set(model.fields["encoder"])
        vars_["repair_mode"].set(model.fields["repair_mode"])

    for key in (*FLOAT_FIELDS, *INT_FIELDS):
        add_entry(key)
    # hidden vars backing the combos
    for key in ("encoder", "repair_mode", "compute_dtype"):
        var = tk.StringVar(value=model.fields[key])
        var.trace_add("write", refresh_preview)
        vars_[key] = var
    enc_var.trace_add("write", combo_changed)
    rep_var.trace_add("write", combo_changed)

    ttk.Label(body, text="Command preview:").grid(row=row, column=0,
                                                  sticky="w")
    ttk.Entry(body, textvariable=preview_var, state="readonly",
              width=80).grid(row=row, column=1, columnspan=2, sticky="ew")
    row += 1

    def do_run() -> None:
        refresh_preview()
        problem = model.validate()
        if problem:
            messagebox.showerror("Invalid parameters", problem)
            return
        if model.running():
            messagebox.showinfo("Running", "pipeline already running")
            return
        model.run()

    def do_debug() -> None:
        files = model.debug_listing()
        messagebox.showinfo(
            "Debug folder",
            "\n".join(files) if files else "(no debug files yet)")

    def do_verify() -> None:
        refresh_preview()
        messagebox.showinfo("Verify Integrity", model.verify_report())

    def do_repair() -> None:
        refresh_preview()
        problem = model.validate()
        if problem:
            messagebox.showerror("Invalid parameters", problem)
            return
        if model.running():
            messagebox.showinfo("Running", "pipeline already running")
            return
        model.repair()

    btns = ttk.Frame(body)
    btns.grid(row=row, column=0, columnspan=3, pady=6)
    tk.Button(btns, text="Run Script", bg="#148C14", fg="white",
              command=do_run).pack(side="left", padx=4)
    tk.Button(btns, text="Stop Script", bg="#8C1414", fg="white",
              command=model.stop).pack(side="left", padx=4)
    ttk.Button(btns, text="View Debug Folder", command=do_debug).pack(
        side="left", padx=4)
    ttk.Button(btns, text="Verify Integrity", command=do_verify).pack(
        side="left", padx=4)
    ttk.Button(btns, text="Repair Subclips", command=do_repair).pack(
        side="left", padx=4)

    refresh_preview()
    root.protocol("WM_DELETE_WINDOW",
                  lambda: (model.stop(), root.destroy()))
    root.mainloop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(run_app())
