// stack_sampler: out-of-process NATIVE stack capture for hung workers.
//
// The port's copy of dlrover_tpu/native/tpu_timer/stack_sampler.cc.
//
// Parity: reference xpu_timer orchestrates gdb/py-spy dumps of arbitrary
// training processes from its per-node daemon
// (xpu_timer/server/hosting_service_server_client.cc, RPC surface
// xpu_timer/protos/hosting_service.proto:14-250). Without gdb or py-spy
// the capability is built directly: ptrace-attach to every thread of the
// target and unwind its USER-SPACE stack with libunwind-ptrace — the
// C/C++ frames a faulthandler dump cannot see (a worker wedged inside
// the CUDA driver or NCCL shows Python blocked in one opaque line; the
// interesting frames are native).
//
// The distro ships libunwind runtime libraries but no headers, so the
// small, ABI-stable slice of the API used here is declared locally and
// resolved with dlopen/dlsym at runtime (x86_64 symbol prefix
// _Ux86_64_). Usage:
//
//     stack_sampler <pid> [max_frames] [scan]
//
// Where libunwind is not installed (or with ``scan``), the sampler walks
// each thread itself: the instruction pointer from PTRACE_GETREGS, then
// the words of the thread's stack above its stack pointer that point
// just past a call instruction in an executable file mapping (return
// addresses; a stack scan finds every frame's, and may also show a stale
// one), symbolized from the mapped ELF's .symtab/.dynsym. No library
// beyond libc is needed.
//
// Output (one block per thread, faulthandler-adjacent format so the
// analysis tool folds it into the same histograms):
//
//     Native thread <tid> (most recent call first):
//       #0 0x00007f... clock_nanosleep+0x47
//       ...
//
// Exit code 0 if at least one thread unwound, 1 otherwise. The target
// keeps running: each thread is seized, interrupted, walked and
// detached (a stop of a few ms per thread, the disturbance py-spy
// imposes). Nothing is queued on the target: a sampler killed at any
// point leaves it running, and a signal that arrives during the stop is
// delivered at the detach.

#include <cxxabi.h>
#include <dirent.h>
#include <dlfcn.h>
#include <elf.h>
#include <errno.h>
#include <fcntl.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/ptrace.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <sys/user.h>
#include <sys/wait.h>
#include <unistd.h>

#include <algorithm>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

// ---- libunwind ABI slice (no headers in the image) ----
using unw_word = unsigned long;
struct UnwCursor {
  // Real unw_cursor_t is 127 words; oversize for safety.
  unw_word opaque[512];
};
using unw_addr_space_t = void*;
constexpr int kUnwRegIp = 16;  // UNW_X86_64_RIP == UNW_REG_IP on x86_64

using create_addr_space_fn = unw_addr_space_t (*)(void* accessors,
                                                  int byteorder);
using destroy_addr_space_fn = void (*)(unw_addr_space_t);
using init_remote_fn = int (*)(UnwCursor*, unw_addr_space_t, void*);
using step_fn = int (*)(UnwCursor*);
using get_reg_fn = int (*)(UnwCursor*, int, unw_word*);
using get_proc_name_fn = int (*)(UnwCursor*, char*, size_t, unw_word*);
using upt_create_fn = void* (*)(pid_t);
using upt_destroy_fn = void (*)(void*);

struct Unwind {
  create_addr_space_fn create_addr_space;
  destroy_addr_space_fn destroy_addr_space;
  init_remote_fn init_remote;
  step_fn step;
  get_reg_fn get_reg;
  get_proc_name_fn get_proc_name;
  void* upt_accessors;
  upt_create_fn upt_create;
  upt_destroy_fn upt_destroy;
};

bool load_unwind(Unwind* u) {
  // libunwind-ptrace links against libunwind-generic; load the arch
  // library RTLD_GLOBAL first so _UPT symbols resolve.
  void* arch = dlopen("libunwind-x86_64.so.8", RTLD_NOW | RTLD_GLOBAL);
  if (!arch) {
    fprintf(stderr, "stack_sampler: %s\n", dlerror());
    return false;
  }
  void* upt = dlopen("libunwind-ptrace.so.0", RTLD_NOW | RTLD_GLOBAL);
  if (!upt) {
    fprintf(stderr, "stack_sampler: %s\n", dlerror());
    return false;
  }
  u->create_addr_space = reinterpret_cast<create_addr_space_fn>(
      dlsym(arch, "_Ux86_64_create_addr_space"));
  u->destroy_addr_space = reinterpret_cast<destroy_addr_space_fn>(
      dlsym(arch, "_Ux86_64_destroy_addr_space"));
  u->init_remote = reinterpret_cast<init_remote_fn>(
      dlsym(arch, "_Ux86_64_init_remote"));
  u->step = reinterpret_cast<step_fn>(dlsym(arch, "_Ux86_64_step"));
  u->get_reg = reinterpret_cast<get_reg_fn>(
      dlsym(arch, "_Ux86_64_get_reg"));
  u->get_proc_name = reinterpret_cast<get_proc_name_fn>(
      dlsym(arch, "_Ux86_64_get_proc_name"));
  u->upt_accessors = dlsym(upt, "_UPT_accessors");
  u->upt_create =
      reinterpret_cast<upt_create_fn>(dlsym(upt, "_UPT_create"));
  u->upt_destroy =
      reinterpret_cast<upt_destroy_fn>(dlsym(upt, "_UPT_destroy"));
  if (!u->create_addr_space || !u->init_remote || !u->step ||
      !u->get_reg || !u->get_proc_name || !u->upt_accessors ||
      !u->upt_create || !u->upt_destroy) {
    fprintf(stderr, "stack_sampler: missing libunwind symbols\n");
    return false;
  }
  return true;
}

std::string demangle(const char* name) {
  int status = 0;
  char* out = abi::__cxa_demangle(name, nullptr, nullptr, &status);
  if (status == 0 && out) {
    std::string s(out);
    free(out);
    return s;
  }
  return name;
}

std::vector<pid_t> list_tids(pid_t pid) {
  std::vector<pid_t> tids;
  char path[64];
  snprintf(path, sizeof(path), "/proc/%d/task", pid);
  DIR* dir = opendir(path);
  if (!dir) return tids;
  while (dirent* ent = readdir(dir)) {
    if (ent->d_name[0] == '.') continue;
    tids.push_back(static_cast<pid_t>(atol(ent->d_name)));
  }
  closedir(dir);
  return tids;
}

// Seize ``tid`` and interrupt it, then wait (at most 200 ms) for it to
// stop; __WALL covers clone threads. PTRACE_SEIZE queues no SIGSTOP:
// if this process dies at any point, the kernel detaches and the thread
// runs on with nothing pending. A thread that does not stop in time
// (asleep in the kernel, say in a driver call) is left seized and is
// released when this process exits. A signal-delivery-stop taken first
// (another signal arrived) leaves that signal in *sig, to be delivered
// at the detach.
bool attach(pid_t tid, int* sig) {
  *sig = 0;
  if (ptrace(PTRACE_SEIZE, tid, nullptr, nullptr) != 0) return false;
  if (ptrace(PTRACE_INTERRUPT, tid, nullptr, nullptr) != 0) return false;
  for (int i = 0; i < 200; ++i) {
    int status = 0;
    pid_t r = waitpid(tid, &status, __WALL | WNOHANG);
    if (r == tid) {
      if (!WIFSTOPPED(status)) return false;  // it exited
      if ((status >> 16) == 0) *sig = WSTOPSIG(status);
      return true;
    }
    if (r < 0 && errno != EINTR) return false;
    usleep(1000);
  }
  errno = ETIMEDOUT;
  return false;
}

void detach(pid_t tid, int sig) {
  ptrace(PTRACE_DETACH, tid, nullptr,
         reinterpret_cast<void*>(static_cast<long>(sig)));
}

int walk_thread(const Unwind& u, pid_t tid, int max_frames) {
  int sig = 0;
  if (!attach(tid, &sig)) {
    fprintf(stderr, "stack_sampler: attach %d failed: %s\n", tid,
            strerror(errno));
    return 0;
  }
  int frames = 0;
  unw_addr_space_t as = u.create_addr_space(u.upt_accessors, 0);
  void* ui = as ? u.upt_create(tid) : nullptr;
  if (ui) {
    UnwCursor cursor;
    memset(&cursor, 0, sizeof(cursor));
    if (u.init_remote(&cursor, as, ui) == 0) {
      printf("Native thread %d (most recent call first):\n", tid);
      do {
        unw_word ip = 0;
        if (u.get_reg(&cursor, kUnwRegIp, &ip) != 0) break;
        char name[512];
        unw_word off = 0;
        if (u.get_proc_name(&cursor, name, sizeof(name), &off) == 0) {
          printf("  #%d 0x%016lx %s+0x%lx\n", frames, ip,
                 demangle(name).c_str(), off);
        } else {
          printf("  #%d 0x%016lx ??\n", frames, ip);
        }
        ++frames;
      } while (frames < max_frames && u.step(&cursor) > 0);
      printf("\n");
    }
    u.upt_destroy(ui);
  }
  if (as) u.destroy_addr_space(as);
  detach(tid, sig);
  return frames;
}


// ---- built-in walker: registers + stack scan + ELF symbols ----

struct Mapping {
  unsigned long start, end, offset;
  bool exec;
  std::string path;
};

std::vector<Mapping> read_maps(pid_t pid) {
  std::vector<Mapping> maps;
  char path[64];
  snprintf(path, sizeof(path), "/proc/%d/maps", pid);
  FILE* f = fopen(path, "r");
  if (!f) return maps;
  char line[4096];
  while (fgets(line, sizeof(line), f)) {
    Mapping m;
    char perms[8] = {0};
    char file[4096] = {0};
    unsigned long inode = 0;
    int n = sscanf(line, "%lx-%lx %7s %lx %*s %lu %4095[^\n]", &m.start,
                   &m.end, perms, &m.offset, &inode, file);
    if (n < 5) continue;
    m.exec = perms[2] == 'x';
    m.path = n > 5 ? file : "";
    size_t p = m.path.find_first_not_of(' ');
    m.path = p == std::string::npos ? "" : m.path.substr(p);
    maps.push_back(m);
  }
  fclose(f);
  return maps;
}

const Mapping* find_mapping(const std::vector<Mapping>& maps,
                            unsigned long addr) {
  for (const Mapping& m : maps)
    if (addr >= m.start && addr < m.end) return &m;
  return nullptr;
}

// One ELF file's function symbols, for address -> name+offset.
struct ElfSymbols {
  struct Sym {
    unsigned long value, size;
    std::string name;
  };
  struct Load {
    unsigned long offset, vaddr, filesz;
  };
  std::vector<Sym> syms;  // sorted by value
  std::vector<Load> loads;

  explicit ElfSymbols(const std::string& path) {
    int fd = open(path.c_str(), O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(Elf64_Ehdr)) {
      close(fd);
      return;
    }
    size_t size = st.st_size;
    void* base = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (base == MAP_FAILED) return;
    const char* img = static_cast<const char*>(base);
    const Elf64_Ehdr* eh = reinterpret_cast<const Elf64_Ehdr*>(img);
    bool ok = memcmp(eh->e_ident, ELFMAG, SELFMAG) == 0 &&
              eh->e_ident[EI_CLASS] == ELFCLASS64 &&
              eh->e_phoff + eh->e_phnum * sizeof(Elf64_Phdr) <= size &&
              eh->e_shoff + eh->e_shnum * sizeof(Elf64_Shdr) <= size;
    if (ok) {
      const Elf64_Phdr* ph =
          reinterpret_cast<const Elf64_Phdr*>(img + eh->e_phoff);
      for (int i = 0; i < eh->e_phnum; ++i)
        if (ph[i].p_type == PT_LOAD)
          loads.push_back({ph[i].p_offset, ph[i].p_vaddr, ph[i].p_filesz});
      const Elf64_Shdr* sh =
          reinterpret_cast<const Elf64_Shdr*>(img + eh->e_shoff);
      for (int i = 0; i < eh->e_shnum; ++i) {
        if (sh[i].sh_type != SHT_SYMTAB && sh[i].sh_type != SHT_DYNSYM)
          continue;
        if (sh[i].sh_link >= eh->e_shnum) continue;
        const Elf64_Shdr& strs = sh[sh[i].sh_link];
        if (sh[i].sh_offset + sh[i].sh_size > size ||
            strs.sh_offset + strs.sh_size > size)
          continue;
        const Elf64_Sym* sym =
            reinterpret_cast<const Elf64_Sym*>(img + sh[i].sh_offset);
        size_t count = sh[i].sh_size / sizeof(Elf64_Sym);
        for (size_t k = 0; k < count; ++k) {
          if (ELF64_ST_TYPE(sym[k].st_info) != STT_FUNC ||
              sym[k].st_value == 0 || sym[k].st_name >= strs.sh_size)
            continue;
          syms.push_back({sym[k].st_value, sym[k].st_size,
                          img + strs.sh_offset + sym[k].st_name});
        }
      }
      std::sort(syms.begin(), syms.end(),
                [](const Sym& a, const Sym& b) { return a.value < b.value; });
    }
    munmap(base, size);
  }

  // The symbol over the file-relative address, or nullptr.
  const Sym* lookup(unsigned long file_off, unsigned long* sym_off) const {
    unsigned long vaddr = 0;
    bool found = false;
    for (const Load& l : loads)
      if (file_off >= l.offset && file_off < l.offset + l.filesz) {
        vaddr = file_off - l.offset + l.vaddr;
        found = true;
        break;
      }
    if (!found) return nullptr;
    auto it = std::upper_bound(
        syms.begin(), syms.end(), vaddr,
        [](unsigned long v, const Sym& s) { return v < s.value; });
    if (it == syms.begin()) return nullptr;
    --it;
    if (it->size && vaddr >= it->value + it->size) return nullptr;
    *sym_off = vaddr - it->value;
    return &*it;
  }
};

class Symbolizer {
 public:
  explicit Symbolizer(const std::vector<Mapping>& maps) : maps_(maps) {}

  std::string name(unsigned long addr) {
    const Mapping* m = find_mapping(maps_, addr);
    char buf[64];
    if (!m || m->path.empty() || m->path[0] != '/') return "??";
    unsigned long file_off = addr - m->start + m->offset;
    auto& elf = files_[m->path];
    if (!elf) elf.reset(new ElfSymbols(m->path));
    unsigned long off = 0;
    if (const ElfSymbols::Sym* s = elf->lookup(file_off, &off)) {
      snprintf(buf, sizeof(buf), "+0x%lx", off);
      return demangle(s->name.c_str()) + buf;
    }
    std::string base = m->path.substr(m->path.rfind('/') + 1);
    snprintf(buf, sizeof(buf), "+0x%lx", file_off);
    return base + buf;
  }

 private:
  const std::vector<Mapping>& maps_;
  std::map<std::string, std::unique_ptr<ElfSymbols>> files_;
};

bool read_remote(pid_t tid, unsigned long addr, void* out, size_t len) {
  iovec local{out, len};
  iovec remote{reinterpret_cast<void*>(addr), len};
  return process_vm_readv(tid, &local, 1, &remote, 1, 0) ==
         static_cast<ssize_t>(len);
}

// Whether ``ret`` follows a call instruction (rel32, or an indirect call
// through a register or memory operand, with or without a REX prefix).
bool after_call(pid_t tid, unsigned long ret) {
  unsigned char b[8];
  if (ret < 8 || !read_remote(tid, ret - 8, b, 8)) return false;
  if (b[3] == 0xe8) return true;                             // call rel32
  if (b[6] == 0xff && (b[7] & 0xf8) == 0xd0) return true;    // call *%reg
  if (b[5] == 0xff && (b[6] & 0x38) == 0x10) return true;    // *disp8 / reg
  if (b[2] == 0xff && (b[3] & 0x38) == 0x10) return true;    // *disp32
  if (b[4] == 0xff && (b[5] & 0x38) == 0x10) return true;    // with SIB
  if (b[1] == 0xff && (b[2] & 0x38) == 0x10) return true;    // SIB+disp32
  return false;
}

// Registers and stack words are read while the thread is stopped; the
// symbols are looked up after it runs again.
int scan_thread(pid_t tid, int max_frames, const std::vector<Mapping>& maps,
                Symbolizer* sym) {
  int sig = 0;
  if (!attach(tid, &sig)) {
    fprintf(stderr, "stack_sampler: attach %d failed: %s\n", tid,
            strerror(errno));
    return 0;
  }
  std::vector<unsigned long> pcs;
  user_regs_struct regs;
  if (ptrace(PTRACE_GETREGS, tid, nullptr, &regs) == 0) {
    pcs.push_back(regs.rip);
    const Mapping* stack = find_mapping(maps, regs.rsp);
    unsigned long top = stack ? stack->end : regs.rsp;
    size_t span = std::min<unsigned long>(top - regs.rsp, 256 * 1024);
    std::vector<unsigned long> words(span / sizeof(unsigned long));
    if (!words.empty() &&
        read_remote(tid, regs.rsp, words.data(),
                    words.size() * sizeof(unsigned long))) {
      for (unsigned long w : words) {
        if (static_cast<int>(pcs.size()) >= max_frames) break;
        const Mapping* m = find_mapping(maps, w);
        if (!m || !m->exec || m->path.empty() || m->path[0] != '/')
          continue;
        if (after_call(tid, w)) pcs.push_back(w);
      }
    }
  }
  detach(tid, sig);
  if (pcs.empty()) return 0;
  printf("Native thread %d (most recent call first):\n", tid);
  for (size_t i = 0; i < pcs.size(); ++i)
    printf("  #%zu 0x%016lx %s\n", i, pcs[i], sym->name(pcs[i]).c_str());
  printf("\n");
  return static_cast<int>(pcs.size());
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <pid> [max_frames] [scan]\n", argv[0]);
    return 2;
  }
  pid_t pid = static_cast<pid_t>(atol(argv[1]));
  int max_frames = argc > 2 ? atoi(argv[2]) : 64;
  bool scan = argc > 3 && strcmp(argv[3], "scan") == 0;
  Unwind u;
  if (!scan && !load_unwind(&u)) {
    fprintf(stderr, "stack_sampler: no libunwind; scanning the stacks\n");
    scan = true;
  }
  std::vector<Mapping> maps;
  std::unique_ptr<Symbolizer> sym;
  if (scan) {
    maps = read_maps(pid);
    sym.reset(new Symbolizer(maps));
  }
  int total = 0;
  for (pid_t tid : list_tids(pid)) {
    total += scan ? scan_thread(tid, max_frames, maps, sym.get())
                  : walk_thread(u, tid, max_frames);
  }
  fflush(stdout);
  return total > 0 ? 0 : 1;
}
