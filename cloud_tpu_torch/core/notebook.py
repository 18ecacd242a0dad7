"""Notebook handling: detection and .ipynb -> .py conversion.

The port's copy of ``cloud_tpu/core/notebook.py``; ``nbconvert``,
``IPython`` and ``google.colab`` stay deferred imports.

Reference analogue: ``run.py:249-263`` (_called_from_notebook IPython
probe) and ``preprocess.py:169-187`` (nbconvert + magic-stripping).
"""

from __future__ import annotations

import os
import re
import tempfile

#: Shell escapes / magics / comments — nbconvert rewrites ``!cmd`` and
#: ``%magic`` into ``get_ipython().…`` calls, so both raw and converted
#: forms are stripped (reference preprocess.py:181-187 stripped the raw
#: forms only because it converted by hand).
_MAGIC_LINE = re.compile(r"^\s*(!|%|#|get_ipython\(\))")


def called_from_notebook() -> bool:
    """True when the current process is an IPython/Colab kernel."""
    try:
        import IPython

        shell = IPython.get_ipython()
        if shell is None:
            return False
        return shell.__class__.__name__ in (
            "ZMQInteractiveShell",  # jupyter
            "Shell",  # colab
        )
    except ImportError:
        return False


def fetch_live_notebook_script(
    output_dir: str | None = None,
    *,
    timeout_sec: int = 200,
    _request=None,
) -> str:
    """Fetch the RUNNING Colab notebook over the kernel RPC and write it
    out as a runnable .py; returns the script path.

    Reference analogue: ``preprocess.py:196-212`` — a blocking
    ``get_ipynb`` request to the Colab frontend (the notebook need not
    exist on disk; Colab keeps it in the browser session), code cells
    concatenated, shell/magic/comment lines stripped.  ``_request`` is the
    test seam for the RPC (the reference's tests mocked the same call).
    """
    request = _request
    if request is None:
        try:
            from google.colab import _message
        except ImportError as exc:
            raise RuntimeError(
                "Live-notebook fetch needs the Colab runtime "
                "(google.colab is not importable)."
            ) from exc

        def request(method, request_body):
            return _message.blocking_request(
                method, request=request_body, timeout_sec=timeout_sec
            )

    response = request("get_ipynb", "")
    if response is None:
        # Same failure contract as the reference (preprocess.py:199-201).
        raise RuntimeError("Unable to get the notebook contents.")
    lines: list[str] = []
    for cell in response["ipynb"]["cells"]:
        if cell.get("cell_type") != "code":
            continue
        source = cell.get("source", [])
        if isinstance(source, str):
            source = source.splitlines()
        for raw in source:
            line = raw.rstrip("\n")
            if not _MAGIC_LINE.match(line):
                lines.append(line)
    output_dir = output_dir or tempfile.mkdtemp(prefix="cloud_tpu_colab_")
    script_path = os.path.join(output_dir, "colab_notebook.py")
    with open(script_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return script_path


def notebook_to_script(notebook_path: str, output_dir: str | None = None) -> str:
    """Convert an .ipynb to a runnable .py, stripping shell/magic/comment
    lines (reference preprocess.py:181-187), and return the script path."""
    from nbconvert import PythonExporter

    exporter = PythonExporter()
    source, _ = exporter.from_filename(notebook_path)
    lines = [ln for ln in source.splitlines() if not _MAGIC_LINE.match(ln)]
    output_dir = output_dir or tempfile.mkdtemp(prefix="cloud_tpu_nb_")
    base = os.path.splitext(os.path.basename(notebook_path))[0]
    script_path = os.path.join(output_dir, base + ".py")
    with open(script_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return script_path
