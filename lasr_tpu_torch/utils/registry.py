"""Config + registry core (copy of ``lasr_tpu/utils/registry.py``).

Every model / tokenizer in a ``config.yaml`` is a
``{name: 'module.path:ClassName', kwargs: {...}}`` block that is
dynamically imported and signature-validated before instantiation.

Name translation: the same ``hparams.yaml`` / ``decode.yaml`` drive both
packages, so class names written for the JAX package (``lasr_tpu.…:Cls``)
or for the reference (``lasr.…:Cls``) resolve onto this package's class of
the same module path (``lasr_tpu_torch.…:Cls``).
"""

from __future__ import annotations

import importlib
import inspect
import warnings
from typing import Any, Dict, Optional

PACKAGE = "lasr_tpu_torch"

# reference (lighting-asr) class paths → this package
REFERENCE_NAME_ALIASES: Dict[str, str] = {
    "lasr.model.e2e_ctc_att.e2e_transformer:E2E_Transformer_CTC":
        "lasr_tpu_torch.models.e2e_ctc_att:E2E_Transformer_CTC",
    "lasr.model.e2e_ctc_att.e2e_transformer_online:E2E_Transformer_CTC_Online":
        "lasr_tpu_torch.models.e2e_online:E2E_Transformer_CTC_Online",
    "lasr.model.e2e_ctc_att.e2e_conformer:E2E_Conformer_CTC":
        "lasr_tpu_torch.models.e2e_ctc_att:E2E_Conformer_CTC",
    "lasr.model.e2e_ctc_att.e2e_transformer_online_offline:"
    "E2E_Transformer_CTC_Univ_Dynamic":
        "lasr_tpu_torch.models.e2e_online:E2E_Transformer_CTC_Univ_Dynamic",
    "lasr.model.e2e_ctc_att.e2e_loss:E2E_Loss":
        "lasr_tpu_torch.models.losses:E2E_Loss",
    "lasr.model.e2e_ctc_att.e2e_loss_univ:CTC_CE_Univ_Loss":
        "lasr_tpu_torch.models.losses_univ:CTC_CE_Univ_Loss",
    "torch.optim:Adam": "lasr_tpu_torch.train.optimizer:Adam",
    "lasr.modules.optimizer.optimizer:Noam":
        "lasr_tpu_torch.train.optimizer:Noam",
    "lasr.modules.optimizer.scheduler:WarmupScheduler":
        "lasr_tpu_torch.train.optimizer:WarmupScheduler",
    "lasr.data.tokenizer:CharTokenizer":
        "lasr_tpu_torch.data.tokenizer:CharTokenizer",
    "lasr.data.tokenizer:HuggingTokenizer":
        "lasr_tpu_torch.data.tokenizer:HuggingTokenizer",
    "lasr.data.dataset:AudioDataSet":
        "lasr_tpu_torch.data.dataset:AudioDataSet",
    "lasr.data.dataset:BatchAudioDataSet":
        "lasr_tpu_torch.data.dataset:BatchAudioDataSet",
    "lasr.modules.net.rnn.lstm:LSTMStack":
        "lasr_tpu_torch.modules.rnn:LSTMStack",
    "lasr.modules.net.rnn.lstm:RNNCellStack":
        "lasr_tpu_torch.modules.rnn:RNNCellStack",
}


def translate_name(import_path: str) -> str:
    """Map a JAX-package or reference class path onto this package."""
    if import_path in REFERENCE_NAME_ALIASES:
        return REFERENCE_NAME_ALIASES[import_path]
    module_name, sep, obj = import_path.partition(":")
    if module_name == "lasr_tpu" or module_name.startswith("lasr_tpu."):
        return PACKAGE + module_name[len("lasr_tpu"):] + sep + obj
    return import_path


def dynamic_import(import_path: str, alias: Optional[Dict[str, str]] = None):
    """Resolve ``'pkg.module:ClassName'`` to the class/function object.

    ``alias`` optionally maps shorthand names to full import paths; an
    explicit alias entry wins over the name translation."""
    alias = alias or {}
    if ":" not in import_path:
        if import_path not in alias:
            raise ValueError(
                f"import path {import_path!r} must contain ':' (e.g. "
                f"'lasr_tpu_torch.models.e2e_ctc_att:E2E_Conformer_CTC') "
                f"or be one of the aliases {sorted(alias)}")
        import_path = alias[import_path]
    elif import_path in alias:
        import_path = alias[import_path]
    translated = translate_name(import_path)
    if translated != import_path and not import_path.startswith("lasr_tpu"):
        warnings.warn(f"config names the reference class {import_path!r}; "
                      f"using {translated!r}", stacklevel=2)
    module_name, _, obj_name = translated.partition(":")
    try:
        module = importlib.import_module(module_name)
    except ImportError:
        if module_name.split(".")[0] == "lasr":
            raise ImportError(
                f"config names the reference module {module_name!r}, which "
                f"has no counterpart in {PACKAGE}") from None
        raise
    try:
        return getattr(module, obj_name)
    except AttributeError as e:
        raise ImportError(f"module {module_name!r} has no attribute "
                          f"{obj_name!r}") from e


def check_kwargs(cls, kwargs: Dict[str, Any], name: Optional[str] = None):
    """Raise ``ValueError`` on any key ``cls.__init__`` does not accept."""
    try:
        params = inspect.signature(cls.__init__).parameters
    except (ValueError, TypeError):
        return
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return
    name = name or getattr(cls, "__name__", str(cls))
    for key in kwargs:
        if key not in params:
            raise ValueError(
                f"initialization of class {name!r} got an unexpected keyword "
                f"argument {key!r}; accepted parameters are {list(params)}")


class BaseConfig:
    """One ``{name, kwargs}`` YAML block, instantiable on demand.

    ``generateExample(*args, **overrides)`` builds the target object;
    call-site keyword arguments override the YAML ones.  ``name`` of
    ``None``/"None" produces a config whose ``generateExample`` returns
    ``None``."""

    def __init__(self, name: Optional[str],
                 kwargs: Optional[Dict[str, Any]] = None, **extra: Any):
        self.conf_dict: Dict[str, Any] = dict(kwargs or {})
        self.extra = extra
        if name is None or name == "None":
            self.name = None
            self.conf_class = None
            return
        self.name = name
        self.conf_class = dynamic_import(name)
        check_kwargs(self.conf_class, self.conf_dict)

    def generateExample(self, *args: Any, **kwargs: Any):
        if self.name is None:
            return None
        merged = dict(self.conf_dict)
        merged.update(kwargs)
        return self.conf_class(*args, **merged)

    def __getitem__(self, key: str) -> Any:
        return self.conf_dict[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if key not in self.conf_dict:
            warnings.warn(f"{key!r} is not in this config", RuntimeWarning)
        self.conf_dict[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.conf_dict

    def get_conf_dict(self) -> Dict[str, Any]:
        return self.conf_dict
