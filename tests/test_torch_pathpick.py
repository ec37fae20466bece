"""PyTorch port: the console file dialog ``ui.pathpick`` (the port's copy
of vr_video_generator_tpu/ui/pathpick.py) — every case of
tests/test_pathpick.py (navigation, filters, search, multi-select, drive
enumeration) against the port's module, and its listings and searches
against the JAX package's on the same tree."""

import os

import pytest

from vr_video_generator_tpu.ui import pathpick as jax_pathpick
from vr_video_generator_tpu_torch.ui.pathpick import (FILTER_SETS,
                                                      FileDialog,
                                                      list_drives,
                                                      list_entries, pick_path)


def make_tree(tmp_path):
    (tmp_path / "clips").mkdir()
    (tmp_path / "clips" / "deep").mkdir()
    (tmp_path / ".hiddendir").mkdir()
    files = ["a.mp4", "b.mkv", "c.txt", ".hidden.mp4",
             "clips/inner.mp4", "clips/deep/nested.mkv", "clips/readme.md"]
    for f in files:
        (tmp_path / f).write_bytes(b"x" * 10)
    return tmp_path


def test_listing_dirs_first_and_filtered(tmp_path):
    root = make_tree(tmp_path)
    d = FileDialog(str(root), filter_name="videos")
    names = [(e.name, e.is_dir) for e in d.entries()]
    assert names == [("clips", True), ("a.mp4", False), ("b.mkv", False)]
    d.set_filter("all")
    assert ("c.txt", False) in [(e.name, e.is_dir) for e in d.entries()]
    d.set_filter(".txt")
    files = [e.name for e in d.entries() if not e.is_dir]
    assert files == ["c.txt"]


def test_hidden_toggle(tmp_path):
    root = make_tree(tmp_path)
    d = FileDialog(str(root), filter_name="videos", show_hidden=True)
    names = [e.name for e in d.entries()]
    assert ".hiddendir" in names and ".hidden.mp4" in names


def test_navigation(tmp_path):
    root = make_tree(tmp_path)
    d = FileDialog(str(root), filter_name="videos")
    assert d.enter(0) is None                      # clips/ -> navigate
    assert d.cwd == str(root / "clips")
    picked = d.enter(1)                            # deep/ at 0, inner.mp4 at 1
    assert picked == str(root / "clips" / "inner.mp4")
    d.up()
    assert d.cwd == str(root)
    assert d.goto(str(root / "clips" / "deep"))
    assert not d.goto(str(root / "a.mp4"))         # not a directory


def test_search_substring_glob_and_depth(tmp_path):
    root = make_tree(tmp_path)
    d = FileDialog(str(root), filter_name="videos")
    d.search("inner")
    assert [e.name for e in d.entries()] == [os.path.join("clips", "inner.mp4")]
    d.search("*.mkv")
    names = [e.name for e in d.entries()]
    assert "b.mkv" in names
    assert os.path.join("clips", "deep", "nested.mkv") in names
    d.search("nested", max_depth=1)                # deep/ is beyond depth 1
    assert d.entries() == []
    d.search(None)
    assert d.search_term is None                   # back to the dir listing
    assert any(e.name == "a.mp4" for e in d.entries())


def test_multi_select_and_single_select(tmp_path):
    root = make_tree(tmp_path)
    d = FileDialog(str(root), filter_name="videos", multi=True)
    d.toggle_select(1)
    d.toggle_select(2)
    assert d.selection == [str(root / "a.mp4"), str(root / "b.mkv")]
    d.toggle_select(1)                             # toggle off
    assert d.selection == [str(root / "b.mkv")]
    s = FileDialog(str(root), filter_name="videos", multi=False)
    s.toggle_select(1)
    s.toggle_select(2)                             # replaces in single mode
    assert s.selection == [str(root / "b.mkv")]


def test_dirs_only_mode(tmp_path):
    root = make_tree(tmp_path)
    d = FileDialog(str(root), dirs_only=True)
    assert [e.name for e in d.entries()] == ["clips"]
    d.toggle_select(0)
    assert d.selection == [str(root / "clips")]


def test_drives_and_shortcuts(tmp_path):
    drives = list_drives()
    assert "/" in drives
    d = FileDialog(str(tmp_path))
    labels = dict(d.shortcuts())
    assert labels["home"] == os.path.expanduser("~")
    assert any(k.startswith("drive") for k in labels)


def test_compat_helpers(tmp_path):
    root = make_tree(tmp_path)
    entries = list_entries(str(root), extensions=(".mp4",))
    assert (".hiddendir", True) in entries         # old helper showed hidden
    assert ("a.mp4", False) in entries
    # scripted single-pick through the interactive loop
    feed = iter(["search inner", "0"])
    out = []
    picked = pick_path(str(root), extensions=(".mp4",),
                       input_fn=lambda _: next(feed), print_fn=out.append)
    assert picked == str(root / "clips" / "inner.mp4")


def test_search_tolerates_dangling_symlink(tmp_path):
    (tmp_path / "clip_a.mp4").write_bytes(b"x")
    os.symlink(tmp_path / "gone.mp4", tmp_path / "clip_dead.mp4")
    d = FileDialog(str(tmp_path))
    d.search("clip")
    names = {e.name for e in d.entries()}
    assert "clip_a.mp4" in names and "clip_dead.mp4" in names


def test_search_results_cached_until_state_changes(tmp_path, monkeypatch):
    (tmp_path / "clip_a.mp4").write_bytes(b"x")
    d = FileDialog(str(tmp_path))
    d.search("clip")
    calls = []
    real = d._search_walk
    monkeypatch.setattr(d, "_search_walk",
                        lambda: calls.append(1) or real())
    d.entries(); d.entries(); d.toggle_select(0)
    assert len(calls) == 1           # render+render+toggle share one walk
    d.show_hidden = True
    d.entries()
    assert len(calls) == 2           # state change invalidates


def test_pick_path_shows_hidden(tmp_path):
    """Round-1 behavior: dotfiles stay selectable through pick_path."""
    (tmp_path / ".hidden_ckpt.pth").write_bytes(b"x")
    ins = iter(["0"])
    out = pick_path(str(tmp_path), input_fn=lambda _: next(ins),
                    print_fn=lambda *_a: None)
    assert out and out.endswith(".hidden_ckpt.pth")


@pytest.mark.parametrize("view", [
    dict(filter_name="videos"), dict(filter_name="all", show_hidden=True),
    dict(dirs_only=True), dict(extensions=(".mkv",), search="*"),
    dict(filter_name="videos", search="clip"), dict(search="e", depth=1)])
def test_entries_equal_the_jax_dialog(tmp_path, view):
    """The same listing or search on the same tree as the JAX package's
    dialog, entry for entry; the drives and filter sets are its own."""
    root = make_tree(tmp_path)
    search, depth = view.pop("search", None), view.pop("depth", 3)
    ours = FileDialog(str(root), **view)
    theirs = jax_pathpick.FileDialog(str(root), **view)
    for d in (ours, theirs):
        d.search(search, max_depth=depth)
    assert [tuple(e.__dict__.values()) for e in ours.entries()] == \
        [tuple(e.__dict__.values()) for e in theirs.entries()]
    assert list_drives() == jax_pathpick.list_drives()
    assert FILTER_SETS == jax_pathpick.FILTER_SETS
