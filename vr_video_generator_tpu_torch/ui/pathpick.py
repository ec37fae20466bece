"""Console file dialog — capability parity with the reference's vendored
dearpygui file dialog (reference file_dialog/fdialog.py:12-908).

The port's own copy of vr_video_generator_tpu/ui/pathpick.py, kept in step
with it (the port imports nothing of the JAX package).

The reference dialog's capabilities, reproduced here without a GUI toolkit
(the state machine is pure and testable, the console loop is a thin shell
over it):

  * drive enumeration          -> ``list_drives`` (``/proc/mounts`` on Linux,
    (fdialog drives combo)        filtered to real block/network filesystems,
                                  plus the Windows-style letters when present)
  * shortcuts pane             -> ``shortcuts`` (home, cwd, mounts)
  * directory navigation       -> ``FileDialog.enter`` / ``up`` / ``goto``
  * extension filters          -> ``FileDialog.set_filter`` (named filter
    (fdialog file_filter combo)   sets, e.g. videos/images/all)
  * search box                 -> ``FileDialog.search`` (substring match,
    (fdialog search_file)         current dir or bounded-depth recursive)
  * multi-select               -> ``FileDialog.toggle_select`` + ``selection``
    (fdialog multi_selection)
  * hidden-file toggle, dirs-first sorting, file sizes — display parity.

``pick_path`` is the single-selection convenience API.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import Callable, List, Optional, Sequence, Tuple

# Named filter sets, mirroring fdialog's extension combos.
FILTER_SETS = {
    "all": None,
    "videos": (".mp4", ".mkv", ".avi", ".mov", ".webm", ".m4v", ".ts"),
    "images": (".png", ".jpg", ".jpeg", ".webp", ".bmp"),
    "models": (".pth", ".safetensors", ".msgpack", ".ckpt"),
}

_PSEUDO_FS = {
    "proc", "sysfs", "devtmpfs", "devpts", "tmpfs", "cgroup", "cgroup2",
    "securityfs", "pstore", "autofs", "mqueue", "debugfs", "tracefs",
    "fusectl", "configfs", "bpf", "binfmt_misc", "hugetlbfs", "rpc_pipefs",
    "overlay", "squashfs", "ramfs", "efivarfs",
}


def list_drives() -> List[str]:
    """Mount points of real filesystems — the reference enumerates drive
    letters via psutil (fdialog.py drives combo); on Linux the analog is
    /proc/mounts minus pseudo filesystems. Always includes '/'."""
    drives = ["/"]
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                _dev, mount, fstype = parts[0], parts[1], parts[2]
                if fstype in _PSEUDO_FS or mount == "/":
                    continue
                if mount.startswith(("/proc", "/sys", "/dev", "/run")):
                    continue
                drives.append(mount.replace("\\040", " "))
    except OSError:
        pass
    # Windows-style drive letters, when running under a layout that has them.
    for letter in "CDEFG":
        root = f"{letter}:\\"
        if os.path.exists(root):
            drives.append(root)
    return sorted(set(drives))


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str            # display name (search results: path relative to cwd)
    path: str            # absolute path
    is_dir: bool
    size: int            # bytes (0 for dirs)


class FileDialog:
    """Pure navigation/selection state machine (console shell: ``run``)."""

    def __init__(self, start: str = ".", filter_name: str = "all",
                 extensions: Optional[Sequence[str]] = None,
                 dirs_only: bool = False, multi: bool = False,
                 show_hidden: bool = False):
        self.cwd = os.path.abspath(start)
        self.filter_name = filter_name
        self._explicit_ext = tuple(e.lower() for e in extensions) if extensions else None
        self.dirs_only = dirs_only
        self.multi = multi
        self.show_hidden = show_hidden
        self.search_term: Optional[str] = None
        self._selected: List[str] = []   # absolute paths, insertion order

    # -- filters -----------------------------------------------------------
    @property
    def extensions(self) -> Optional[Tuple[str, ...]]:
        if self._explicit_ext is not None:
            return self._explicit_ext
        return FILTER_SETS.get(self.filter_name)

    def set_filter(self, name: str) -> None:
        if name.startswith("."):
            self._explicit_ext = (name.lower(),)
            self.filter_name = name
            return
        if name not in FILTER_SETS:
            raise KeyError(f"unknown filter {name!r} "
                           f"(have {sorted(FILTER_SETS)} or '.ext')")
        self._explicit_ext = None
        self.filter_name = name

    def _match(self, name: str) -> bool:
        if not self.show_hidden and name.startswith("."):
            return False
        ext = self.extensions
        if ext is None:
            return True
        return os.path.splitext(name)[1].lower() in ext

    # -- listing / search ----------------------------------------------------
    def entries(self) -> List[Entry]:
        """Current view: search results when a search is active, else the
        directory listing (dirs first, then filtered files) — fdialog's
        table contents."""
        if self.search_term is not None:
            return self._search_entries()
        try:
            names = sorted(os.listdir(self.cwd))
        except OSError:
            return []
        out: List[Entry] = []
        for name in names:
            path = os.path.join(self.cwd, name)
            if os.path.isdir(path):
                if self.show_hidden or not name.startswith("."):
                    out.append(Entry(name, path, True, 0))
        if not self.dirs_only:
            for name in names:
                path = os.path.join(self.cwd, name)
                if not os.path.isdir(path) and self._match(name):
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    out.append(Entry(name, path, False, size))
        return out

    def search(self, term: Optional[str], max_depth: int = 3,
               max_results: int = 500) -> None:
        """Set (or clear, with None/'') the active search. Substring match,
        case-insensitive; '*'/'?' switch to glob semantics."""
        self.search_term = term if term else None
        self._search_depth = max_depth
        self._search_cap = max_results
        self._search_cache = None

    def _search_entries(self) -> List[Entry]:
        # Each render AND each selection toggle re-reads entries(); without a
        # cache an active search re-walks the whole tree every time. The key
        # covers everything the result depends on; navigation clears
        # search_term, which invalidates via the key.
        key = (self.cwd, self.search_term, self.filter_name,
               self._explicit_ext, self.show_hidden)
        cached = getattr(self, "_search_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        out = self._search_walk()
        self._search_cache = (key, out)
        return out

    def _search_walk(self) -> List[Entry]:
        term = self.search_term.lower()
        is_glob = any(ch in term for ch in "*?[")
        out: List[Entry] = []
        base_depth = self.cwd.rstrip(os.sep).count(os.sep)
        for root, dirs, files in os.walk(self.cwd):
            if root.rstrip(os.sep).count(os.sep) - base_depth >= self._search_depth:
                dirs[:] = []
            if not self.show_hidden:
                dirs[:] = [d for d in dirs if not d.startswith(".")]
            candidates = (dirs if self.dirs_only else dirs + files)
            for name in sorted(candidates):
                low = name.lower()
                hit = (fnmatch.fnmatch(low, term) if is_glob else term in low)
                if not hit:
                    continue
                path = os.path.join(root, name)
                is_dir = os.path.isdir(path)
                if not is_dir and not self._match(name):
                    continue
                rel = os.path.relpath(path, self.cwd)
                if is_dir:
                    size = 0
                else:
                    try:
                        size = os.path.getsize(path)
                    except OSError:  # dangling symlink / deleted mid-walk
                        size = 0
                out.append(Entry(rel, path, is_dir, size))
                if len(out) >= self._search_cap:
                    return out
        return out

    # -- navigation ----------------------------------------------------------
    def enter(self, index: int) -> Optional[str]:
        """Enter directory at index, or return the file's path (single-select
        semantics). Out-of-range indices are ignored."""
        ents = self.entries()
        if not 0 <= index < len(ents):
            return None
        e = ents[index]
        if e.is_dir:
            self.cwd = e.path
            self.search_term = None
            return None
        return e.path

    def up(self) -> None:
        self.cwd = os.path.dirname(self.cwd) or "/"
        self.search_term = None

    def goto(self, path: str) -> bool:
        path = os.path.expanduser(path)
        if os.path.isdir(path):
            self.cwd = os.path.abspath(path)
            self.search_term = None
            return True
        return False

    def shortcuts(self) -> List[Tuple[str, str]]:
        """(label, path) pairs — fdialog's left pane."""
        items = [("home", os.path.expanduser("~")), ("cwd", os.getcwd())]
        items += [(f"drive {d}", d) for d in list_drives()]
        return items

    # -- selection -----------------------------------------------------------
    def toggle_select(self, index: int) -> None:
        ents = self.entries()
        if not 0 <= index < len(ents):
            return
        e = ents[index]
        if self.dirs_only and not e.is_dir:
            return
        if e.path in self._selected:
            self._selected.remove(e.path)
        elif self.multi:
            self._selected.append(e.path)
        else:
            self._selected = [e.path]

    @property
    def selection(self) -> List[str]:
        return list(self._selected)

    # -- console shell -------------------------------------------------------
    def render(self, print_fn: Callable = print) -> None:  # pragma: no cover
        flt = self.filter_name
        mode = f" search:{self.search_term!r}" if self.search_term else ""
        print_fn(f"[{self.cwd}] filter={flt}{mode} "
                 f"selected={len(self._selected)}")
        for i, e in enumerate(self.entries()):
            mark = "*" if e.path in self._selected else " "
            kind = "/" if e.is_dir else f"  {e.size:,}B"
            print_fn(f" {mark}{i:3d}: {e.name}{kind}")

    def run(self, input_fn=input, print_fn=print) -> Optional[List[str]]:  # pragma: no cover - interactive
        """Interactive loop. Returns selected path list, or None on cancel.
        Commands: <n> enter/select, sel <n..>, .. up, this, drives, goto <p>,
        search <term>, filter <name|.ext>, hidden, ok, empty=cancel."""
        while True:
            self.render(print_fn)
            line = input_fn("path> ").strip()
            if line == "":
                return None
            cmd, _, arg = line.partition(" ")
            if cmd == "..":
                self.up()
            elif cmd == "this":
                return [self.cwd]
            elif cmd == "ok":
                if self._selected:
                    return self.selection
                print_fn("nothing selected")
            elif cmd == "sel":
                for tok in arg.split():
                    if tok.isdigit():
                        self.toggle_select(int(tok))
            elif cmd == "drives":
                for label, path in self.shortcuts():
                    print_fn(f"  {label}: {path}")
            elif cmd == "goto":
                if not self.goto(arg):
                    print_fn("not a directory")
            elif cmd == "search":
                self.search(arg or None)
            elif cmd == "filter":
                try:
                    self.set_filter(arg)
                except KeyError as e:
                    print_fn(str(e))
            elif cmd == "hidden":
                self.show_hidden = not self.show_hidden
            elif cmd.isdigit():
                picked = self.enter(int(cmd))
                if picked:
                    return [picked]
            elif os.path.exists(os.path.expanduser(line)):
                return [os.path.abspath(os.path.expanduser(line))]
            else:
                print_fn("commands: <n>, sel <n..>, .., this, ok, drives, "
                         "goto <p>, search <t>, filter <f>, hidden; "
                         "empty=cancel")


def list_entries(directory: str,
                 extensions: Optional[Sequence[str]] = None) -> list:
    """Compatibility helper: [(name, is_dir)] dirs first, hidden entries
    shown."""
    d = FileDialog(directory, extensions=extensions, show_hidden=True)
    return [(e.name, e.is_dir) for e in d.entries()]


def pick_path(start: str = ".", extensions: Optional[Sequence[str]] = None,
              input_fn=input, print_fn=print) -> Optional[str]:  # pragma: no cover - interactive
    """Single-path convenience picker. show_hidden=True: checkpoints under
    dot-directories must stay reachable."""
    result = FileDialog(start, extensions=extensions,
                        show_hidden=True).run(input_fn, print_fn)
    return result[0] if result else None
