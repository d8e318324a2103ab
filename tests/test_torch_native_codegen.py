"""Twins of ``test_codegen_cpp.py``: C++ stubs from the port's protoc
plugin (``--tpurpc_torch_out=cpp:DIR``, ``tpurpc_torch/codegen/plugin.py``)
compiled with the system protobuf against the port's C sources, all four
call shapes end to end, and both packages' generated Python stubs calling
the generated C++ service.

The proto is this file's own (``torch_codegen_cpp.proto``, package
``torchdemo``); the Python clients run in child processes, so that no
generated ``_pb2`` module enters this process's default descriptor pool.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torch_native import cpp_program

REPO = Path(__file__).resolve().parent.parent

PROTO = textwrap.dedent("""\
    syntax = "proto3";
    package torchdemo;

    message Ping { string text = 1; int32 n = 2; }
    message Pong { string text = 1; int32 total = 2; }

    service Greeter {
      rpc Hello (Ping) returns (Pong);
      rpc Tail (Ping) returns (stream Pong);
      rpc Sum (stream Ping) returns (Pong);
      rpc Chat (stream Ping) returns (stream Pong);
    }
    """)

MAIN_CC = textwrap.dedent("""\
    // Generated-stub exercise: C++ service + C++ client, all four shapes.
    #include <cstdio>
    #include "torch_codegen_cpp_tpurpc.pb.h"

    class GreeterImpl : public torchdemo::GreeterService {
     public:
      int Hello(const ::torchdemo::Ping &req, ::torchdemo::Pong *resp)
          override {
        resp->set_text("hello " + req.text());
        resp->set_total(req.n());
        return 0;
      }
      int Tail(const ::torchdemo::Ping &req,
               ::tpurpc::ServerCall<::torchdemo::Ping, ::torchdemo::Pong>
                   &call) override {
        for (int i = 0; i < req.n(); ++i) {
          ::torchdemo::Pong p;
          p.set_total(i);
          if (!call.Write(p)) return TPR_UNAVAILABLE;
        }
        return 0;
      }
      int Sum(::tpurpc::ServerCall<::torchdemo::Ping, ::torchdemo::Pong>
                  &call) override {
        ::torchdemo::Ping in;
        int total = 0;
        while (call.Read(&in)) total += in.n();
        if (call.parse_error()) return TPR_INTERNAL;
        ::torchdemo::Pong out;
        out.set_total(total);
        return call.Write(out) ? 0 : TPR_UNAVAILABLE;
      }
      int Chat(::tpurpc::ServerCall<::torchdemo::Ping, ::torchdemo::Pong>
                   &call) override {
        ::torchdemo::Ping in;
        while (call.Read(&in)) {
          ::torchdemo::Pong out;
          out.set_text("echo:" + in.text());
          if (!call.Write(out)) return TPR_UNAVAILABLE;
        }
        return 0;
      }
    };

    int main(int argc, char **argv) {
      tpr_server *srv = tpr_server_create(0);
      GreeterImpl impl;
      impl.RegisterWith(srv);
      tpr_server_start(srv);
      int port = tpr_server_port(srv);
      if (argc > 1) {  // serve-only mode for the cross-language test
        printf("PORT %d\\n", port);
        fflush(stdout);
        getchar();
        tpr_server_destroy(srv);
        return 0;
      }

      ::tpurpc::Channel ch("127.0.0.1", port);
      torchdemo::GreeterClient stub(ch);

      ::torchdemo::Ping req;
      req.set_text("cpp");
      req.set_n(7);
      ::torchdemo::Pong resp;
      auto st = stub.Hello(req, &resp, 5000);
      printf("hello_ok=%d text=%s total=%d\\n", st.ok(),
             resp.text().c_str(), resp.total());

      auto tail = stub.Tail(req, 5000);
      int seen = 0, last = -1;
      ::torchdemo::Pong m;
      while (tail.Read(&m)) { seen++; last = m.total(); }
      auto tst = tail.Finish();
      printf("tail_ok=%d seen=%d last=%d\\n", tst.ok(), seen, last);

      auto sum = stub.Sum(5000);
      for (int i = 1; i <= 4; ++i) {
        ::torchdemo::Ping p;
        p.set_n(i);
        sum.Write(p);
      }
      sum.WritesDone();
      ::torchdemo::Pong total;
      bool got = sum.Read(&total);
      auto sst = sum.Finish();
      printf("sum_ok=%d got=%d total=%d\\n", sst.ok(), got, total.total());

      auto chat = stub.Chat(5000);
      ::torchdemo::Ping c1;
      c1.set_text("x");
      chat.Write(c1);
      ::torchdemo::Pong r1;
      bool cgot = chat.Read(&r1);
      chat.WritesDone();
      ::torchdemo::Pong drain;
      while (chat.Read(&drain)) {}
      auto cst = chat.Finish();
      printf("chat_ok=%d echo=%s\\n", cst.ok() && cgot, r1.text().c_str());

      auto [ust, _body] = ch.UnaryCall("/torchdemo.Greeter/Nope", "", 5000);
      printf("unknown_code=%d\\n", ust.code);

      tpr_server_destroy(srv);
      return 0;
    }
    """)

#: a Python client of ``root``'s generated stubs against the C++ service
CLIENT = textwrap.dedent("""\
    import sys
    import torch_codegen_cpp_pb2 as pb2
    import {stubs} as gen
    import {root}.rpc as rpc

    with rpc.Channel(f"127.0.0.1:{{sys.argv[1]}}") as ch:
        stub = gen.GreeterStub(ch)
        pong = stub.Hello(pb2.Ping(text="py", n=3), timeout=10)
        tail = [p.total for p in stub.Tail(pb2.Ping(n=4), timeout=10)]
        s = stub.Sum(iter([pb2.Ping(n=i) for i in (5, 6)]), timeout=10)
        chat = [p.text for p in stub.Chat(
            iter([pb2.Ping(text="a"), pb2.Ping(text="b")]), timeout=10)]
    print("PY", pong.text, pong.total, tail, s.total, chat)
    """)


def _shim(out: Path, root: str) -> Path:
    shim = out / f"protoc-gen-{root}"
    shim.write_text(f"#!/bin/sh\nexec {sys.executable} -m "
                    f"{root}.codegen.plugin\n")
    shim.chmod(0o755)
    return shim


@pytest.fixture(scope="module")
def cpp_build(tmp_path_factory):
    if shutil.which("g++") is None or shutil.which("protoc") is None:
        pytest.skip("no g++/protoc toolchain")
    try:
        pb_flags = subprocess.run(
            ["pkg-config", "--cflags", "--libs", "protobuf"],
            capture_output=True, text=True, check=True).stdout.split()
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("no C++ protobuf")
    out = tmp_path_factory.mktemp("torch_cppgen")
    (out / "torch_codegen_cpp.proto").write_text(PROTO)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run(
        ["protoc", f"--plugin=protoc-gen-tpurpc={_shim(out, 'tpurpc')}",
         f"--plugin=protoc-gen-tpurpc_torch={_shim(out, 'tpurpc_torch')}",
         f"--cpp_out={out}", f"--python_out={out}",
         f"--tpurpc_torch_out=cpp:{out}", f"--tpurpc_torch_out={out}",
         f"--tpurpc_out={out}", f"-I{out}", "torch_codegen_cpp.proto"],
        check=True, env=env, timeout=120)
    (out / "main.cc").write_text(MAIN_CC)
    cflags = [f for f in pb_flags if not f.startswith("-l")]
    libs = [f for f in pb_flags if f.startswith("-l") or f.startswith("-L")]
    binp = cpp_program("torch_codegen_cpp_app",
                       [out / "main.cc", out / "torch_codegen_cpp.pb.cc"],
                       "both", extra=libs, cflags=["-I", str(out), *cflags])
    return out, binp


def test_cpp_generated_stubs_all_shapes(cpp_build):
    _, binp = cpp_build
    out = subprocess.run([binp], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr)
    for want in ("hello_ok=1 text=hello cpp total=7",
                 "tail_ok=1 seen=7 last=6", "sum_ok=1 got=1 total=10",
                 "chat_ok=1 echo=echo:x", "unknown_code=12"):
        assert want in out.stdout, out.stdout


def test_python_stub_against_cpp_generated_service(cpp_build):
    """Both packages' generated Python stubs, each on its own package's
    channel, call the generated C++ service alike."""
    gen_dir, binp = cpp_build
    proc = subprocess.Popen([binp, "serve"], stdout=subprocess.PIPE,
                            stdin=subprocess.PIPE, text=True)
    try:
        port = proc.stdout.readline().split()[1]
        got = {}
        for root, stubs in (("tpurpc", "torch_codegen_cpp_tpurpc"),
                            ("tpurpc_torch",
                             "torch_codegen_cpp_tpurpc_torch")):
            env = dict(os.environ, GRPC_PLATFORM_TYPE="TCP",
                       PYTHONPATH=os.pathsep.join(
                           [str(gen_dir), str(REPO),
                            os.environ.get("PYTHONPATH", "")]))
            res = subprocess.run(
                [sys.executable, "-c", CLIENT.format(root=root, stubs=stubs),
                 port], capture_output=True, text=True, env=env, timeout=120)
            assert res.returncode == 0, res.stderr[-3000:]
            got[root] = [ln for ln in res.stdout.splitlines()
                         if ln.startswith("PY")]
    finally:
        proc.stdin.close()
        proc.wait(timeout=10)
    assert got["tpurpc_torch"] == got["tpurpc"] == [
        "PY hello py 3 [0, 1, 2, 3] 11 ['echo:a', 'echo:b']"]
