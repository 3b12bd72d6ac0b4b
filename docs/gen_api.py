"""Generate the markdown API reference into docs/api/ by introspection.

The environment ships neither sphinx nor pdoc, so this ~100-line generator
fills the role of the reference's Sphinx tree (/root/reference/doc/api/):
one page per module, every public class with its signature, method table and
full docstring (the math lives in the docstrings).

Run:  JAX_PLATFORMS=cpu python docs/gen_api.py
"""
import importlib
import inspect
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import jax

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "pycsou_tpu._module",
    "pycsou_tpu.core.map",
    "pycsou_tpu.core.linop",
    "pycsou_tpu.core.functional",
    "pycsou_tpu.core.solver",
    "pycsou_tpu.core.arith",
    "pycsou_tpu.ops.basic",
    "pycsou_tpu.ops.conv",
    "pycsou_tpu.ops.diff",
    "pycsou_tpu.ops.sampling",
    "pycsou_tpu.ops.stack",
    "pycsou_tpu.ops.kron",
    "pycsou_tpu.ops.transform",
    "pycsou_tpu.func.base",
    "pycsou_tpu.func.penalty",
    "pycsou_tpu.func.loss",
    "pycsou_tpu.opt.proxalgs",
    "pycsou_tpu.opt.fuse",
    "pycsou_tpu.opt.admm",
    "pycsou_tpu.opt.tv",
    "pycsou_tpu.opt.mcmc",
    "pycsou_tpu.math.prox",
    "pycsou_tpu.math.green",
    "pycsou_tpu.parallel.mesh",
    "pycsou_tpu.parallel.sharded",
    "pycsou_tpu.parallel.spatial",
    "pycsou_tpu.parallel.solvers",
    "pycsou_tpu.kernels.band",
    "pycsou_tpu.kernels.tv",
    "pycsou_tpu.utils.opnorm",
    "pycsou_tpu.utils.stats",
    "pycsou_tpu.utils.diagnostics",
    "pycsou_tpu.utils.checkpoint",
    "pycsou_tpu.utils.profiling",
    "pycsou_tpu.utils.compile_cache",
    "pycsou_tpu.utils.misc",
]

SKIP_METHODS = {"tree_flatten", "tree_unflatten", "replace"}


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + line for line in d.splitlines())


def render_module(name: str) -> str:
    mod = importlib.import_module(name)
    lines = [f"# `{name}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    public = getattr(mod, "__all__", None)
    if public is None:
        public = [n for n in vars(mod) if not n.startswith("_")]
    for attr in public:
        obj = getattr(mod, attr, None)
        if obj is None or getattr(obj, "__module__", name) != name:
            # re-exports are documented where they are defined
            if not (inspect.isclass(obj) or inspect.isfunction(obj)):
                continue
            if getattr(obj, "__module__", None) != name:
                continue
        if inspect.isclass(obj):
            bases = ", ".join(b.__name__ for b in obj.__bases__ if b is not object)
            lines.append(f"## class `{attr}`" + (f" ({bases})" if bases else ""))
            lines.append("")
            doc = _doc(obj)
            if doc:
                lines += [doc, ""]
            init = obj.__dict__.get("__init__")
            if init is not None:
                lines.append(f"**constructor** `{attr}{_sig(init)}`")
                lines.append("")
            def _mro_doc(mname, meth):
                """Doc of the method, inheriting from the MRO when an
                override carries none (the Sphinx convention)."""
                d = inspect.getdoc(meth)
                if d:
                    return d
                for base in obj.__mro__[1:]:
                    bm = base.__dict__.get(mname)
                    if bm is not None:
                        bd = inspect.getdoc(bm.fget if isinstance(bm, property) else bm)
                        if bd:
                            return bd
                return ""

            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith("_") or mname in SKIP_METHODS:
                    continue
                if isinstance(meth, property):
                    d = _mro_doc(mname, meth.fget)
                    lines.append(f"- **property `{mname}`** — {d.splitlines()[0] if d else ''}")
                elif inspect.isfunction(meth):
                    first = _mro_doc(mname, meth).splitlines()
                    lines.append(f"- **`{mname}{_sig(meth)}`** — {first[0] if first else ''}")
            lines.append("")
        elif inspect.isfunction(obj):
            lines.append(f"## `{attr}{_sig(obj)}`")
            lines.append("")
            doc = _doc(obj)
            if doc:
                lines += [doc, ""]
    return "\n".join(lines) + "\n"


def main():
    out_dir = pathlib.Path(__file__).resolve().parent / "api"
    out_dir.mkdir(exist_ok=True)
    index = ["# pycsou_tpu API reference", "", "Generated by `docs/gen_api.py`.", ""]
    for name in MODULES:
        page = render_module(name)
        fname = name.replace("pycsou_tpu.", "").replace(".", "_") + ".md"
        (out_dir / fname).write_text(page)
        first = page.splitlines()[2] if len(page.splitlines()) > 2 else ""
        index.append(f"- [`{name}`]({fname}) — {first[:100]}")
    (out_dir / "index.md").write_text("\n".join(index) + "\n")
    print(f"wrote {len(MODULES) + 1} pages to {out_dir}")


if __name__ == "__main__":
    main()
