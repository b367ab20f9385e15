"""The port's text pipeline (text/vocabulary.py, text/sentence_buffer.py,
postproc/correction.py, postproc/translation.py, output/handlers.py,
utils/context.py) against the JAX package's: each case runs the same
scenario through both packages and compares what comes out (exactly: these
are host code, copies of the reference's), and checks the expected value.
Correction, translation and the HTTP action talk to one local stub server
that both packages share; the fail-open paths use a dead local port."""

import base64
import datetime
import importlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

PKGS = ("openhush_tpu", "openhush_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(scenario):
    """scenario(pkg) for each package → the port's result, after checking
    that it equals the reference's."""
    ref, port = (scenario(pkg) for pkg in PKGS)
    assert port == ref
    return port


@pytest.fixture(scope="module")
def llm_stub():
    requests = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self._reply({"models": []})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            requests.append((self.path, body))
            if self.path == "/api/generate":
                self._reply({"response": f"LLM[{body.get('prompt', '')}]"})
            elif self.path == "/hook":
                self._reply({"ok": True})
            else:
                self._reply({}, 404)

        def _reply(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", requests
    httpd.shutdown()


# ---------- vocabulary ----------

VOCABS = {
    "word boundaries": ('[medical]\ncase_sensitive = false\n'
                        '"acetaminophen" = "Tylenol"\n',
                        ["take Acetaminophen daily", "xacetaminophens"],
                        ["take Tylenol daily", "xacetaminophens"]),
    "case sensitive": ('[names]\ncase_sensitive = true\n"jon" = "Jon"\n',
                       ["jon said hi", "JON said hi"],
                       ["Jon said hi", "JON said hi"]),
    "longest first": ('[a]\n"new york" = "New York"\n"new" = "NEW"\n',
                      ["new york and new things"],
                      ["NEW York and NEW things"]),
    "disabled section": ('[off]\nenabled = false\n"foo" = "bar"\n',
                         ["foo"], ["foo"]),
}


@pytest.mark.parametrize("case", list(VOCABS))
def test_vocabulary_matches_reference(tmp_path, case):
    content, inputs, expected = VOCABS[case]
    p = tmp_path / "vocab.toml"
    p.write_text(content)

    def run(pkg):
        v = mod(pkg, "text.vocabulary").VocabularyManager(
            str(p), reload_interval_secs=0.0)
        return [v.apply(t) for t in inputs], v.rule_count

    outs, _ = both(run)
    assert outs == expected


def test_vocabulary_hot_reload_matches_reference(tmp_path):
    def run(pkg):
        p = tmp_path / f"{pkg}.toml"
        p.write_text('[a]\n"foo" = "bar"\n')
        v = mod(pkg, "text.vocabulary").VocabularyManager(
            str(p), reload_interval_secs=0.0)
        first = v.apply("foo")
        p.write_text('[a]\n"foo" = "baz"\n')
        os.utime(p, (0, 9999999999))
        return first, v.check_reload(), v.apply("foo")

    assert both(run) == ("bar", True, "baz")


# ---------- sentence buffer ----------

SENTENCES = {
    "basic": (None, ["Hello wor", "ld. How are", " you? "],
              [[], ["Hello world."], ["How are you?"]], None),
    "quotes": (None, ['He said "stop." Then left.'],
               [['He said "stop."', "Then left."]], None),
    "force flush": (20, ["a" * 25], [["a" * 25]], None),
    "remainder": (None, ["incomplete thought"], [[]], "incomplete thought"),
}


@pytest.mark.parametrize("case", list(SENTENCES))
def test_sentence_buffer_matches_reference(case):
    max_buffer, chunks, expected, rest = SENTENCES[case]

    def run(pkg):
        cls = mod(pkg, "text.sentence_buffer").SentenceBuffer
        b = cls() if max_buffer is None else cls(max_buffer=max_buffer)
        return [b.add(c) for c in chunks], b.flush()

    assert both(run) == (expected, rest)


# ---------- correction and translation ----------

@pytest.mark.parametrize("mode", ["conservative", "moderate", "aggressive",
                                  None])
def test_correction_prompt_matches_reference(mode):
    def run(pkg):
        c = mod(pkg, "postproc.correction")
        cfg = (c.CorrectionConfig(remove_fillers=False) if mode is None else
               c.CorrectionConfig(remove_fillers=True, filler_mode=mode))
        return c.TextCorrector(cfg).build_prompt("um so the thing")

    prompt = both(run)
    assert ("filler" in prompt.lower()) == (mode is not None)


def test_correction_roundtrip_matches_reference(llm_stub):
    url, _ = llm_stub

    def run(pkg):
        c = mod(pkg, "postproc.correction")
        tc = c.TextCorrector(c.CorrectionConfig(ollama_url=url))
        return tc.correct("um hello world"), tc.is_available()

    out, available = both(run)
    assert out.startswith("LLM[") and available


def test_correction_fails_open_as_reference():
    def run(pkg):
        c = mod(pkg, "postproc.correction")
        tc = c.TextCorrector(c.CorrectionConfig(
            ollama_url="http://127.0.0.1:1", timeout_secs=0.5))
        return tc.correct("keep me intact"), tc.is_available()

    assert both(run) == ("keep me intact", False)


def test_translator_ollama_matches_reference(llm_stub):
    url, requests = llm_stub

    def run(pkg):
        t = mod(pkg, "postproc.translation")
        tr = t.Translator(t.TranslationConfig(
            backend="ollama", ollama_url=url, target_language="de"))
        n = len(requests)
        out = tr.add_chunk("Hallo Welt. Unvollst"), tr.flush()
        return out, [b for _, b in requests[n:]]

    (pieces, rest), sent = both(run)
    assert len(pieces) == 1 and pieces[0].startswith("LLM[")
    assert rest.startswith("LLM[") and len(sent) == 2


def test_translator_whisper_passthrough_and_unknown_backend():
    def run(pkg):
        t = mod(pkg, "postproc.translation")
        out = t.Translator(t.TranslationConfig(backend="whisper")).translate(
            "bonjour")
        with pytest.raises(ValueError, match="unknown backend") as e:
            t.Translator(t.TranslationConfig(backend="nope"))
        return out, str(e.value)

    assert both(run)[0] == "bonjour"


def test_translator_m2m100_needs_its_checkpoint(tmp_path, monkeypatch):
    """backend='m2m100' reaches each package's own M2M-100 translator,
    which asks for the converted checkpoint when there is none."""
    monkeypatch.setenv("OPENHUSH_MODEL_DIR", str(tmp_path))

    def run(pkg):
        t = mod(pkg, "postproc.translation")
        with pytest.raises(FileNotFoundError, match="M2M-100 checkpoint") \
                as e:
            t.Translator(t.TranslationConfig(backend="m2m100"))
        return str(e.value).splitlines()[0]

    assert both(run).endswith("m2m100.npz")


# ---------- output actions ----------

def test_action_substitution_matches_reference():
    def run(pkg):
        h = mod(pkg, "output.handlers")
        ctx = h.ActionContext(
            text='say "hi"', duration_secs=2.5, model="tiny", seq_id=7,
            timestamp=datetime.datetime(2026, 8, 16, 9, 30, 1))
        return (ctx.substitute("{text}|{text_escaped}|{date}|{time}|"
                               "{duration}|{model}|{seq_id}"),
                ctx.substitute("{text_base64}"),
                h.sanitize_for_shell("a`b$(c)${d}$[e]\0f"))

    assert both(run) == ('say "hi"|say \\"hi\\"|2026-08-16|09:30:01|2.5|'
                         'tiny|7', base64.b64encode(b'say "hi"').decode(),
                         "a'b(c){d}[e]f")


def test_shell_action_and_injection_guard_match_reference(tmp_path):
    def run(pkg):
        h = mod(pkg, "output.handlers")
        out = tmp_path / f"{pkg}.txt"
        marker = tmp_path / f"{pkg}.pwned"
        ok = h.ShellAction(f"echo -n {{text}} > {out}").execute(
            h.ActionContext(text="hello"))
        guarded = h.ShellAction("echo {text}").execute(
            h.ActionContext(text=f"`touch {marker}`"))
        h.ShellAction("echo {text}").execute(
            h.ActionContext(text=f"$(touch {marker})"))
        return ok, out.read_text(), guarded, marker.exists()

    assert both(run) == (True, "hello", True, False)


def test_file_and_http_actions_match_reference(tmp_path, llm_stub):
    url, requests = llm_stub

    def run(pkg):
        h = mod(pkg, "output.handlers")
        p = tmp_path / f"{pkg}.log"
        a = h.FileAction(str(p), "{seq_id}: {text}\n")
        a.execute(h.ActionContext(text="one", seq_id=1))
        a.execute(h.ActionContext(text="two", seq_id=2))
        n = len(requests)
        ok = h.HttpAction(url=f"{url}/hook",
                          body='{"text": "{text_escaped}", "model": '
                               '"{model}"}').execute(
            h.ActionContext(text="ping", model="base"))
        runner = h.ActionRunner.from_config_list([
            {"type": "file", "path": str(p)},
            {"type": "http", "url": f"{url}/hook"},
            {"type": "shell", "command": "true"}])
        ran = runner.run_all(h.ActionContext(text="x"))
        with pytest.raises(ValueError, match="unknown action type"):
            h.action_from_config({"type": "nope"})
        return p.read_text(), ok, requests[n:], ran

    text, ok, sent, ran = both(run)
    assert text == "1: one\n2: two\nx\n" and ok and ran == 3
    assert sent[0] == ("/hook", {"text": "ping", "model": "base"})


@pytest.mark.parametrize("mode", ["clipboard", "paste", "both", "none"])
def test_output_handler_stdout_path_matches_reference(mode, monkeypatch,
                                                      capsys):
    """With no clipboard or paste tool on PATH the handler prints the text
    to stdout, as the reference's does; with a fallback it calls that."""
    monkeypatch.setenv("PATH", "")

    def run(pkg):
        h = mod(pkg, "output.handlers")
        h.OutputHandler(mode=mode).output("to stdout")
        got = []
        h.OutputHandler(mode=mode, separator="|",
                        fallback=got.append).output("b", continuation=True)
        return capsys.readouterr().out, got

    assert both(run) == ("to stdout\n", ["b"])


def test_app_profiles_match_reference(monkeypatch):
    raw = [{"name": "code", "app_match": "Editor",
            "vocabulary_path": "/v.toml"},
           {"app_match": "slack", "filler_mode": "aggressive"},
           {"name": "no match key"}]

    def run(pkg):
        ctx_mod = mod(pkg, "utils.context")
        monkeypatch.setattr(mod(pkg, "utils.platform"), "active_window",
                            lambda: {"app": "MyEDITOR", "title": "x"})
        profiles = ctx_mod.profiles_from_config(raw)
        ctx = ctx_mod.AppContext(profiles)
        active = ctx.refresh()
        return ([tuple(vars(p).values()) for p in profiles],
                active.name, ctx.current_app,
                ctx.find_profile("Slack desktop").name,
                ctx.find_profile(""))

    profiles, active, app, slack, none = both(run)
    assert len(profiles) == 2 and active == "code" and app == "MyEDITOR"
    assert slack == "slack" and none is None
